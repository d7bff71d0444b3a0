#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

0. device: the card's name, and ``nvidia-smi``'s name and power limit.
1. build: nvcc compiles ``bsvd_tpu_torch/csrc/*.cu`` for sm_90a, one
   process per source, all started together.
2. kernels: each kernel in every variant the BSVD-c64 paths use, at their
   site shapes, in bf16, against its plain PyTorch version run in fp32 on
   the same bf16 values (cuDNN TF32 off); kernel and plain times are
   CUDA-event medians of 10 runs after warm-up, beside each site's bound
   (its FLOPs at the H100's 989 TFLOP/s of dense bf16, or its bytes, each
   input read once and each output written once, at 3.35 TB/s, whichever
   is longer) and the time of one cuDNN call that does the site's conv
   arithmetic on inputs prepared beforehand (``library_ms``; none for the
   two-conv K2 and K6, which get ``library_pair_ms`` instead: the site's
   two cuDNN convs, each on its input prepared beforehand, the
   intermediate included). Whole-clip sites (10
   frames): K1 conv3x3, K2 conv_chain, K3 conv_s2, K4 conv_ps. Streaming
   sites (one frame, or 8 for push_block): K5 bibuffer_conv (F = 1) and
   bibuffer_multi (F = 8), K6 bibuffer_chain (K5 and K6 at both widths and
   in both modes: the route not taken is timed with count 0; each K6 site
   also against the two K5 steps on its inputs, ``two_k5_ms``, and
   ``equals_two_k5``, whether y, s1' and s2' are the same bits: a report),
   and K1 (shift 'none', the drain conv), K2, K3, K4 at one frame. K5
   states and K6's s1' must equal the plain version exactly. Train sites
   (8 clips x 11 frames of 96x96, the c64 train step's 28 weight
   gradients): K7 conv3x3_dw against the
   fp32 weight gradient of the same bf16 values, its plain time that of
   cuDNN's bf16 wgrad (the shift and addend materialised first), and K1 at
   the 4 chain intermediates that the step's backward recomputes. The
   generation-1 shift-conv entry (``shift_conv_fused_v1``, K1 with no
   second input) at its whole-clip sites.
3. MIMO main path: ``build_network`` BSVD-c64 (random weights from a seed),
   ``denoise_seq`` of 3 clips of (10, 3, 540, 960) at sigma 20/255 in bf16,
   for the bidirectional and the causal net; the launch counters must show
   16 / 4 / 4 / 4 launches of K1 / K2 / K3 / K4 per forward, and
   F.conv2d is made to raise while the path runs.
4. parity: the same weights on a reduced clip, fp32 kernels on the card
   against the plain fp32 path on the CPU, and the bf16 kernel path's PSNR
   against that fp32 output beside the plain bf16 path's (CPU); then bf16
   against fp32 kernels at 540p (max |diff| and PSNR).
5. streaming main path, both nets: ``StreamDenoiser`` push of a 24-frame
   540x960 bf16 clip, then flush (F.conv2d made to raise); the launches of
   every push must match the port's fill / steady / drain rule and
   MemCvBlock route (``archs/streaming.chain_route``: a MemCvBlock that it
   chains runs as one K6 when both its buffers are primed, any other as
   two K5 steps; steady: K2 4, K3 4, K4 4, K1 0, and K6 8 / K5 0 where
   every MemCvBlock chains, K5 16 / K6 0 where none does), and a steady
   push_block of 8 frames must launch K5 16 times and K2 / K3 / K4 4
   times. The 24 outputs,
   and the push_block's, against fp32 MIMO by PSNR (no more than 1 dB below
   bf16 MIMO's). Then steady ms/frame of push (64 pushes, best of 3) and
   of push_block(8), state bytes, peak memory, and the device idle share
   of 16 steady pushes under ``torch.profiler``.
6. streaming parity: fp32 streaming kernels against fp32 MIMO kernels on a
   reduced clip (1e-4 x max|ref|), by the port's MemCvBlock route and
   again by the other one (``CHAIN_MAX_C`` set for that run: the route not
   on the main path, K6 or two K5, still runs through ``_memcv_step``),
   and ``denoise_seq(mode='streaming')`` of a 10-frame clip against
   ``mode='mimo'`` by the same PSNR rule.
6a. a whole clip over the device budget: phase 4's 10-frame 540p clip in
   bf16 through ``denoise_seq`` (mode 'mimo') with
   ``seq_inference._memory_budget`` lowered to half the gate's estimate of
   its activations: the streaming route runs (its warning logged, K5 and
   K1 / K3 / K4 at one frame launched, no F.conv2d), held to the fp32
   whole-clip output by phase 4's PSNR rule; wall ms a frame.
7. train_grad: one fp32 ``DenoisingModel`` step of the full-width c64 TSN
   on 2 clips x 5 frames of 64x64, kernels on the card against the plain
   path on the CPU (same weights and batch): the loss and every gradient
   to 1e-4 x max|ref| per tensor, the CPU backward taking the card's
   activation masks (a pre-activation within rounding of 0 or 6 may
   take the other side of the clip on the other device: the count of such
   flips is reported), and the parameters after the Adam step against the
   CPU optimizer fed the card's gradients.
8. train main path: options/train/bsvd_c64_unblind.yml through
   ``parse_options`` (batch 8 x 11 frames of 96x96, sigma ~ U[5, 55]/255
   per clip, MSE, Adam 1e-3, betas (0.9, 0.99); every phase's options come
   from the shipped files, changed only by --force_yml), fp32 and bf16
   AMP, on one repeated batch
   made by the ported augment and noise code from seeded synthetic uint8
   clips: 5 warm-up and 30 timed steps with F.conv2d raising; every step
   must launch K1 20, K2 4, K3 4, K4 4 and K7 28 times (the
   generation-1 entry 14), the losses must be finite and the mean of
   steps 21-30 below that of steps 1-10. Then ms/step and it/s at batch 8
   and 16, peak memory, the device idle share and device time per kernel
   group (K7 and cuDNN's wgrad / dgrad apart) of 8 steps under
   ``torch.profiler`` (the idle share also of the unprofiled step time,
   which the profiler's host cost does not stretch), and
   ``train.train_loop``'s save -> auto-resume round
   trip (EMA on) bit-equal to the uninterrupted run.

9. chunked main path: ``denoise_seq(temp_psz=11, future_buffer_len=2)``
   (the train yml's validation protocol) of a 25-frame 540x960 clip in
   bf16, both nets, F.conv2d made to raise: each chunk (two with the
   look-ahead, then the reflect-padded 3-frame tail) must launch K1 32
   times (16 zero-boundary shift convs, 14 through the generation-1
   entry, and 16 one-frame recomputes of frame 0), K2 / K3 / K4 4. fp32
   kernels against the plain fp32 path on the CPU, chunked the same way
   (13 frames of 64x112 at temp_psz 4, look-ahead 2: the sticky disable
   and a tail), to 1e-4 x max|ref|; bf16 at full size by phase 4's rule
   (chunked bf16 against chunked fp32 no more than 1 dB below the whole
   clip's bf16 against fp32; the causal net's chunked output against its
   whole-clip fp32 output, the same function); ``BlockStreamDenoiser(8,
   2)`` push / flush equal to ``denoise_seq(temp_psz=8,
   future_buffer_len=2)`` bit for bit. Then ms per 13-frame chunk (events,
   median of 10) and per kept frame, the same 13 frames through the
   zero-boundary MIMO forward (the difference is the frame-0 recomputes'
   and carry copies' share), wall seconds of an 85-frame clip numpy in,
   numpy out, and BlockStreamDenoiser ms per frame (push, best of 3).
10. eval main path, the test command line: ``test_pipeline(root,
   cmd=['-opt', yml])`` on a test option file written here
   (options/test/bsvd_c64.yml's network_g, val and logger blocks verbatim,
   its pretrain_ckpt line dropped; random c64 weights saved as a ``.npz``
   checkpoint for path.pretrain_network_g; one ValFolderDataset on phase
   12's 13-frame 540x960 PNG folder at sigma 20/255, padded to 544
   rows), whole clip and, with --force_yml, by the train yml's chunked
   protocol: finite metrics, K1-K4 launches per clip, every frame read by
   the zlib PNG reader (the route printed), the per-scene CSVs and the
   saved frames, clip00's psnr_float against denoise_seq's output scored
   by hand; host seconds per clip for read, denoise, metrics and save.
11. WNet options (random weights from the seed, BN given seeded running
   statistics): options/test/bsvd_raw.yml's network_g (in 5, out 4,
   residual 4), options/train/bsvd_c32_blind.yml's, and c64 with
   shift_input (bidirectional and causal), norm 'bn' and norm 'in'. Each:
   one bf16 10-frame 540p forward with F.conv2d raising, its launches by
   the routes (``option_launches``: BN folded runs the kernels of norm
   'none'; 'in' splits every K2 pair into two K1 launches; shift_input
   adds two K1 shift convs a stage in place of inc's K2), the forward's
   ms (events, median of 5) beside c64 'none''s in the same phase; fp32
   on the card against the plain fp32 path on the CPU with the CPU
   weights (4 frames of 64x112; the stream and a chunk too for the pushed
   nets), to 1e-4 x max|ref|, and bf16 by phase 4's PSNR rule. The
   pushed nets (shift_input both modes, 'in'): 24 540p frames pushed and
   flushed, each steady push's and a push_block's launches checked, and
   steady ms per frame; shift_input's 13-frame chunk (launches, ms). Then
   train steps at the train yml's batch: 'bn' with train.fp16 asked for
   (and ignored: fp32), shift_input and c64 with and without remat in
   bf16 AMP: launches per step, ms per step, peak memory. For 'in', the
   device profile of one forward and of 8 steady pushes (busy time, idle
   share, the top kernels by device time).

12. the entry points on PNG frame folders (in a scratch root): first, before
   phase 10, synthetic PNG folders written with the port's encoder (train:
   4 clips x 24 frames at 480x854, DAVIS's frame size; val: 1 x 13 at
   540x960; odd frames with PNG filters 0-4 on their rows, even ones with
   filter 0), read back exactly, and the zlib reader's ms per whole frame
   and per 11-frame 96x96 window. Then ``train_video_loader`` alone with
   the train yml's loader options (batches a second, default workers and
   one), and the train command line, ``train_pipeline(root, cmd=['-opt',
   options/train/bsvd_c64_unblind.yml, '--force_yml', ...])``, c64 at the
   yml's widths and batch, --force_yml setting only the folders, 13
   validation frames, 20 iterations, print / save every 10 / 20 and one
   validation after the last: fp32, bf16 AMP, then an --auto_resume to 22
   (no validation). Each run: K1-K4
   launched, K7 28 times a step, the checkpoint, state and option-file
   copy written, the timers' ms per iteration and data time, the frames'
   route, and (fp32, bf16) the same model's step on one repeated
   in-memory batch.
12a. JPEG frames: ``data/jpeg_decode`` held bit for bit to the committed
   fixtures (``tests/fixtures/jpeg``: cv2-written files of each kind and
   ``decoded.npz``, libjpeg-turbo's decode); phase 12's clips written as
   JPEG (quality 95, 4:2:0) by the port's writer (``utils/jpeg_encode``)
   and read back (PSNR against the source above 25 dB; 11-frame 96x96
   windows equal to the crop of the whole decode); ms per whole 480p and 540p frame and
   per window, and the loader's batches a second, each beside PNG's timed
   in the same phase. Then phase 10's test CLI once (whole clip) on the
   JPEG val folders and phase 12's train CLI once on the JPEG folders
   (bf16 AMP, 10 iterations, one validation of 10 frames a clip): the
   frames' routes (JPEG only), K1-K4 launched (K7 28 a step), the ms per
   iteration and the data wait.
13. parallel: N = 1, 2, 4, 8 bidirectional bf16 540x960 streams through
   one ``StreamDenoiser(batch=N)``, stream k the 24-frame clip rolled by
   k frames: all 24 frames pushed and flushed, each stream held by phase
   4's PSNR rule against the fp32 MIMO forward of its own clip; ms per
   steady push (64 pushes, best of 3) and per frame per stream, state per
   stream, peak memory, the launches of a steady push (the same for every
   N). The host ms of one rank's batch noise (``noisy_batch``, 8 x 11 x
   96x96), its own rows against the rows of 8 ranks' global batch. Then
   ``python -m bsvd_tpu_torch.parallel.dryrun`` with two gloo ranks that
   share cuda:0 (``--size full``): the 544x960 whole clip and stream (24
   pushes, a push_block of 8, a flush) in fp32 and bf16 with the rows
   over both ranks, three fp32 train steps at 8 x 11 x 96 x 96 a
   rank as data 2 x spatial 1 and data 1 x spatial 2, and two of the c64
   net with norm 'bn' (2 x 1, 1 x 2) and norm 'in' (1 x 2), their
   statistics the global batch's (one all-reduce a site), each held by the
   dryrun against the unsharded call on the card (fp32 1e-4 x max|ref|,
   bf16 phase 4's PSNR rule, the first step's gradients, every step's
   loss within 1e-4 relative, the parameters and BN running statistics
   within 2 x lr a step of the unsharded run's and the same bits on both
   ranks; a normed layout's gradients and losses within 3x fp32's own gap
   there, the unsharded step's on the plain route, where that is larger;
   rank 0 runs the unsharded steps); per rank its launches (K2 and K6 none under the row mask or at
   a normed site; K1, K3, K4 and K7 on every rank), gathered bytes, the
   norms' all-reduces a step and ms (two processes on one card: no
   scaling number). In the same spawn StyleGAN2Model (out_size 64,
   narrow 0.25, batch 4, R1 and the path penalty at iteration 2) and
   SRModel at msrresnet_x4.yml's widths with a VGG19 perceptual and style
   loss of criterion 'fro' (gt 128, batch 4), two iterations each on the
   two ranks, held against their serial runs on the card (every logged
   value within 1e-4 x max(1, |ref|), or 3x the gap of a serial run with
   its samples reversed, the states within 2 x lr an iteration, the same
   bits on both ranks). ``"multi_card"`` says "1 device", or holds
   the NCCL dryrun over every card. Last, the train CLI under
   ``python -m torch.distributed.run --nproc_per_node 1`` with
   ``--launcher pytorch`` (NCCL, world size 1; this script as the rank,
   calling ``train_pipeline`` as ``python -m bsvd_tpu_torch.train``
   does), bf16, 10 iterations on phase 12's PNG folders: K1-K4 and K7
   launched, one checkpoint, ms per iteration beside phase 12's bf16 run.
14. the profiler: ``python -m bsvd_tpu_torch.profile_net -opt
   options/test/bsvd_c64.yml --trace`` as a subprocess (the reference's
   protocol: a 1 x 10 x 540 x 960 bf16 forward, best of 3 x 5): its lines
   in the root profile.py's order, its params equal to ``count_params`` of
   phase 3's net, its FLOPs equal to the valid-tap count of the c64 convs
   (``c64_convs``, counted tap by tap here) and within 1% of phase 2's
   padded per-forward FLOPs, K1-K4 at 16 / 4 / 4 / 4 launches; its ms and
   peak memory beside phase 3's. Then ``python -m
   bsvd_tpu_torch.tools.parse_trace <trace> --group --json``: the traced
   forward launched K1-K4 at those counts and no library convolution
   (the no-fallback check); device busy ms, idle share, the longest gaps
   and what the host was doing. Phase 12's bf16 train CLI run (which sets
   a PSNR metric for its validation) read back from its ``tb_logger``
   event files with the port's reader: every CRC, ``losses/l_pix`` at
   each print equal to the text log's ``.4e`` value, ``metrics/psnr`` and
   its per-folder tags at the validation. The gray-mode and Adam7
   fixtures (``tests/fixtures/frames``, cv2's decodes in
   ``decoded.npz``; the JPEG fixtures' Y planes) decoded bit for bit.
   Phases 5, 8, 11 and 12 take their device profiles from
   ``bsvd_tpu_torch.profiler.device_profile``.

15. zoo_sr: the zoo's image-SR family and BSVD's perceptual loss, fp32
   with TF32 off unless said. Parity: MSRResNet 64x16 x4, EDSR 64x16 x4,
   RRDBNet 64x23x32 x4, RCAN 10x20 (its RCABs' convs scaled by 0.1: at
   the JAX init 200 residual blocks grow to ~1e30) and RIDNet on 2 x 3 x
   64 x 64, VGG19's conv5_4 features and VGGStyleDiscriminator128 (eval)
   on 2 x 3 x 128 x 128, the card against the CPU with the same weights,
   to 1e-4 x max|ref|. The train CLI on options/train/msrresnet_x4.yml and
   esrgan_x4.yml (--force_yml pointing at 16 synthetic DIV2K _sub-layout
   GT PNGs of 480 x 480 with their 4x4-mean LQs and a Set5-layout val
   set): 20 iterations at the yml's batch 16 and gt_size 128, ms an
   iteration over 11-20 (the wait for data and the step), peak memory,
   the validation PSNR and that of the reloaded checkpoint (the same to
   1e-3 dB); ESRGAN's losses, EMA, both networks' files and both
   optimizers in the resume state, the random VGG's warning; an ESRGAN
   run with net_d_init_iters 5 (G the same bits through iteration 5).
   The SR loader's batches a second with 1 and 4 workers. BSVD's c64
   bf16 step (phase 8's batch) with the VGG19 conv5_4 perceptual loss:
   K1-K4 and K7 launches per step (on the kernels line), the loss terms,
   ms per step beside phase 8's plain bf16 step, peak memory; phase 7's
   fp32 step card against CPU with the loss, the WNet's masks and the
   perceptual loss's discontinuities (VGG ReLU masks, max-pool picks,
   the l1 signs) shared, to 1e-4 x max|ref| per tensor.
16. mp4: the train loader's mp4 route on the card. Fixture clips from
   tools/make_video_fixtures.py (H.264 of I_PCM / P_Skip macroblocks,
   which decode exactly to the planes written): IDR/P 320 x 240, IDR/P
   854 x 480 (coded 864 x 480), High-profile B frames with ctts and an
   edit list at 416 x 234, 24 frames each. The refusals name their
   cause: an mp4 on the CPU (NVDEC), a missing libnvcuvid (a fresh
   process), cuvidGetDecoderCaps for H.264 4:2:0 / 4:4:4 / 4:2:2 8-bit
   and 4:2:0 10-bit. From every start of each fixture, libnvcuvid's
   parser (``nvdec.parse``: host code) on the port's CUVID structs: its
   sequence equal to the SPS, one picture a sample, the demuxer's
   display order. NVDEC counts as hidden only on
   ``nvdec.NvdecNotExposed`` (cuvidGetDecoderCaps out of memory where
   NVIDIA_DRIVER_CAPABILITIES lacks 'video'); any other caps failure
   fails the phase. The kernel nv12_rgb against its plain version, bit
   for bit, at odd and even window origins and the whole 854 x 480 frame
   (NVDEC's planes, or the writer's where NVDEC is hidden); both timed
   (CUDA events, median of 50) on an 11 x 96 x 96 window beside its
   bound (bytes at 3.35 TB/s). Where NVDEC is exposed: its NV12 from
   every start equal to the writer's planes, and its frames a second;
   the yml's loader (one worker, the same seed) over 4 mp4 clips x 24
   frames at 854 x 480 and over PNG folders of the same RGB frames: the
   same 3 batches; the train CLI on options/train/bsvd_c64_unblind.yml
   over the mp4 folder: bf16 AMP, 30 iterations, one validation of 10
   frames a clip; K1-K4 and K7 launches per step, ms an iteration over
   11-30 (the wait and the step) and over 3-10, beside phase 12's PNG
   run and 12a's JPEG run; the loader's batches a second with 1 and 8
   workers. Where it is hidden these runs cannot decode: the record says
   "not run" with the driver's error, and nv12_rgb's main-path launches
   are 0 (its ``main_path`` says why).
17. zoo_vsr: the zoo's recurrent video SR, plain PyTorch (no kernel of
   the port on its path, as the JAX package computes it in XLA), fp32
   with TF32 off. One BasicVSR forward at the yml's widths (64 features,
   30 blocks) on 5 frames of 64 x 64, the card against the CPU with the
   same seeded weights, to 1e-4 x max|ref|. A REDS-layout train tree (2
   clips x 20 frames, GT 256 x 320 PNGs of a moving textured field, 4x4-
   mean LQs) and a REDS4-layout val tree (2 clips x 15 frames, LQ 90 x
   160); the train CLI on options/train/basicvsr_reds.yml, --force_yml
   changing only the folders, ``network_g:spynet_path=~`` (no SpyNet
   weights in the repository), 20 iterations, fix_flow 10 and the print /
   save / validation frequencies: the yml's batch 1, 15 frames, gt_size
   256, one validation after the last iteration. Ms an iteration over
   11-20 (the wait for data and the step), peak memory, SpyNet's weights
   the same bits through iteration 9 and moved at 10, both Adams' counts,
   the validation PSNR and seconds a clip, the checkpoint; the device
   profile of one more step (busy ms, idle share,
   the top kernels); then ``--auto_resume`` to 25 iterations.
18. k2_route, tiff_frames, tools: K2's width gate (``ops/conv_chain.fits``)
   against the kernel at each limit (bf16 256, 192 with x2; fp32 192:
   the widest launches, 64 more is refused); the c64 net with interm_ch
   320 in bf16 at 10 x 540 x 960 (inc as two K1 launches, outc on K2:
   K2 2, K1 20 a forward) by phase 4's PSNR rule against the fp32 plain
   route, and in fp32, and with chns[0] 256 too (every chain split, K2
   0), on 3 x 136 x 240 against the plain route to 1e-4 x max|ref|. A
   540 x 960 frame written as TIFF by the port (LZW and Deflate with
   predictor 2, none) and as PNG: read back equal, ms a decode of each
   and of a 96 x 96 TIFF window. ``tools/run_eval_burnin`` (the JAX
   repo's option file) on one 11-frame 540 x 960 .tif folder at sigma 20
   (``test_pipeline``; K1-K4 at one forward's counts, every frame by the
   TIFF reader, finite metrics) and on a 10-frame DAVIS-shaped PNG folder;
   then each timing tool once at full width (BSVD-c64, 540 x 960 bf16
   clip and stream, the batch-16 train step with ``--real-data``), in
   this process: its JSON line parsed, every kernel it times held against
   its plain version by the tool (fp32 1e-4 x max|ref|, bf16 2^-6 x max(1,
   max|ref|)); the tools' numbers and seconds.
19. face_parity, face_data, face_hifacegan_cli, face_stylegan2_cli,
   face_inference (the zoo's face GANs; fp32, TF32 off; no kernel of the
   port on these paths): HiFaceGAN at num_feat 48 (64 x 64 LQ), StyleGAN2's
   256 Cmul2 generator (stored noise, two styles) and discriminator, card
   against CPU to 1e-4 x max|ref|. 8 synthetic 512 x 512 faces (LQ: the
   ported prepare_hifacegan_dataset's sr4x template, 4x INTER_AREA down,
   INTER_CUBIC up, on the card) and 16 of 256 x 256. The train CLI on
   options/train/hifacegan_sr4x.yml at its widths (num_feat 48, gt_size
   512, batch 1, VGG19 perceptual at random weights), --force_yml
   changing the folders and total_iter (20) only: ms an iteration over
   11-20 and the share spent waiting, peak memory, finite losses, every
   D spectral-norm u moved, its one validation's PSNR. The train CLI on a
   yml of BasicSR's train_StyleGAN2_256_Cmul2_FFHQ.yml widths and losses
   (FFHQDataset, mean / std 0.5, wgan_softplus, r1 10 every 16, path 2
   every 4, mixing 0.9, Adam 2e-3, batch 4), 16 iterations: ms a plain,
   path and r1 + path iteration (each between two synchronizations), peak
   memory, both penalties nonzero, and one more iteration of each kind
   under the profiler (device busy ms, idle share, the top kernels).
   Then ``python -m
   bsvd_tpu_torch.inference.inference_stylegan2 --size 1024 --sample 4``
   on random weights saved here, ``inference_esrgan`` and
   ``inference_ridnet`` on two synthetic PNGs each, the three at once:
   the images' shapes, command seconds.
20. video_parity, video_steps, video_edvr_data, video_edvr_cli,
   video_edvr_profile, video_inference_basicvsr (the rest of the zoo's
   video family; fp32, TF32 off; no kernel of the port on these paths):
   at published widths, card against CPU to 1e-4 x max|ref|, every DCN
   pack's ``conv_offset`` random: EDVR-M on 5 frames of 64 x 64, IconVSR
   (64 x 30, key frames every 5, temporal padding 2) on 15 frames, TOFlow
   and DUF x4 (52 layers) on 7; 3 VideoRecurrentModel steps of IconVSR
   (SpyNet frozen at step 1) and 3 VideoGANModel steps with EDVR-M as G,
   card against CPU, each step from the card's weights (losses 1e-4,
   each optimizer group's gradients 5e-2 in L2: ``STEP_GRAD_TOL``). The
   train CLI on ``EDVR_YML`` (BasicSR's
   train_EDVR_M_x4_SR_REDS_M.yml values), --force_yml changing the
   folders (REDS-layout trees at 720 x 1280 GT / 180 x 320 LQ), lmdb to
   disk, no pretrained file, total_iter 20 and tsa_iter 11: ms an
   iteration over 12-20 and the share spent waiting, peak memory, finite
   losses, the warm phase (conv_first still, fusion moving) and the
   unfreeze, its one validation's PSNR and seconds a clip; one more
   iteration under the profiler (busy ms, idle share, the top kernels).
   Then ``python -m bsvd_tpu_torch.inference.inference_basicvsr`` on a
   20-frame 64 x 64 folder with random weights saved here: the outputs,
   command seconds.
21. faces_cv2_ops, faces_dfdnet, faces_paste, faces_hifacegan_prep,
   faces_usm_noise_niqe (cv2's image operations in the port and the
   modules on them; fp32, TF32 off; no kernel of the port on these
   paths): each ``utils/cv2_ops`` operation on card tensors against the
   same call on the CPU at its callers' sizes (uint8 bit for bit, float32
   1e-5), its card ms and peak memory. ``FaceRestorationHelper`` with
   given 5- and 68-point landmarks (dlib is absent) on a synthetic 1024 x
   1024 frame, DFDNet at num_feat 64 on the 512 x 512 crop with a
   synthetic dictionary (``DFD_ATOMS`` atoms, ``DFD_ATOM_HW``; the last
   conv scaled so the tanh does not saturate on random weights): the card
   against the CPU (the chosen atoms equal, the output within 1e-4 x
   max|ref|), ms a face; ``paste_faces_to_input_image`` at upscale 2
   (2048 x 2048, the PNG write included) against the CPU helper, ms.
   Every ``prepare_hifacegan_dataset`` template over 8 GT faces at 512,
   the script's LQ files on the card equal to its CPU run's, ms a face.
   ``usm_sharp`` and ``usm_sharp_torch`` (card against CPU; the batched
   form in float64, its cuDNN blur flipping threshold masks in fp32), the
   batched degradation noise on a given noise tensor, NIQE on a 480 x 640
   frame with a synthetic parameter file (1e-5 relative), ms and peak
   memory. Phase 19's HiFaceGAN LQ comes from the sr4x template.
22. swinir_forward, swinir_train_cli, swinir_step_grad, swinir_inference,
   inception, fid_scripts, lpips, diffjpeg (fp32, TF32 off; no kernel of
   the port on these paths: the phase asserts it adds no launch):
   SwinIR classical x2 at BasicSR's SRx2 widths (``SWINIR_YML``) on a
   678 x 1020 DIV2K LR frame, fp32 and bf16 autocast, ms a frame and peak
   memory, the card against the CPU on a 64 x 64 crop; the train CLI on
   ``SWINIR_YML`` for 20 iterations on synthetic 480 x 480 pairs (ms an
   iteration over 11-20, the wait share, peak memory, the validation's
   seconds), one step's gradients card against CPU, and the
   ``inference_swinir`` command; the TF-FID InceptionV3 from a random
   ``.pth`` at a batch of 64 of 256 x 256 resized to 299 (ms a batch,
   images a second), the three FID scripts as commands on a 256-image
   folder (the folder against its own statistics gives ~0) and a random
   StyleGAN2 256 Cmul2; LPIPS at 512 x 512 (ms a pair, card against
   CPU) and ``calculate_lpips`` on 16 PNG pairs; DiffJPEG on 12 x 3 x 256
   x 256 at qualities drawn from [30, 95], ms of the forward and of
   forward + backward, the quantised coefficients card against CPU (the
   flips counted). Device profiles of one SwinIR frame (fp32, bf16) and
   of one train step, kernels grouped. The five commands run last, at once
   (their seconds share card and host), the two FID commands against the
   statistics computed in this process first; the statistics command's
   file equal to them to 1e-4 x max|ref|.
23. storage_scripts, storage_sr_train_cli, storage_vimeo90k,
   storage_npz_round_trip (the zoo's storage and last scripts; the data
   scripts on the host, the MATLAB scripts' imresize and the SR CLI on
   the card): BasicSR's DIV2K preparation on two synthetic 2040 x 1356 HR
   PNGs: ``generate_bicubic_img`` (mod 12, x4, on the card), then
   ``extract_subimages`` (HR 480 / 240, LR 120 / 60: 40 pairs an image),
   ``generate_meta_info`` and ``create_lmdb`` of each sub-image folder
   (each script by its ``main(argv)`` here, the host-only ones in threads;
   their seconds); the stores' bytes. The
   train CLI on options/train/msrresnet_x4.yml copied with ``io_backend:
   {type: lmdb}`` and the stores, 20 iterations, then on the sub-image
   folders: their first batches bit-equal, first losses within 1e-6
   relative, ms an iteration over 6-20 and the wait share of each. A
   Vimeo90K septuplet tree (4 sequences of 448 x 256),
   ``generate_LR_Vimeo90K`` on the card, ``create_lmdb`` of both
   ``sequences`` folders (keys ``<clip>/<seq>/im<i>``): every
   Vimeo90KDataset / Vimeo90KRecurrentDataset item from the stores
   bit-equal to the item from the folders. A random c64 TSN ``.pth``
   through ``convert_to_npz --tsn``: the nets built from the ``.pth`` and
   from the ``.npz`` each run a 10-frame 540p bf16 whole-clip forward on
   K1-K4 (their launches on the kernels line), bit-equal. Memcached and
   the downloads need a server: they are held on the CPU only
   (tests/test_torch_io_utils.py).

Every phase's line carries ``t_s``, the seconds since the run started;
``phase_seconds`` gives each phase's seconds.

Any failed check raises (exit code != 0). The line before the last is
``{"kernels": [...]}``: per kernel, its launches in the main-path runs of
phases 3, 5, 6a, 8, 9, 10, 11, 12, 12a, 13, 14, 15, 16, 18 and 23 (counters set to
0 before each run, read after; phase 13's ranks and phase 14's profile entry count
their runs in their own processes), the
largest max |diff| of phase 2, and ``ms`` / ``plain_ms`` / ``library_ms``
/ ``library_pair_ms`` / ``bound_ms``, the phase-2 site medians and bounds
summed at the counts of
one bidirectional unit of work (``bound_by``: ``operations`` or ``bytes``,
whichever dominates the summed bound), named by
``per``: a 10-frame forward (K1-K4 and the generation-1 entry), a steady
push (K5 bibuffer_conv, K6), a steady push_block of 8 frames (K5
bibuffer_multi) or a c64 train step at batch 8 (K7). Where the main path
routes every MemCvBlock through K5 (``CHAIN_MAX_C`` 0), K6 is off it: its
``launches`` are 0, its times one launch at each bidirectional site
(``per`` says so), and ``off_path_launches`` holds each kernel's launches
in phase 6's other-route run. Its last entry is nv12_rgb (phase 16):
its launches in the mp4 loader run and the CLI run (0 where NVDEC is
hidden, ``main_path`` naming the cause), ``ms`` / ``plain_ms``
/ ``bound_ms`` per 11 x 96 x 96 window; no single PyTorch call converts
NV12 to RGB (``library_ms`` null).
The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import csv
import io
import json
import math
import logging
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from bsvd_tpu_torch.archs import build_network  # noqa: E402
from bsvd_tpu_torch.archs import streaming  # noqa: E402
from bsvd_tpu_torch.archs.streaming import (StreamDenoiser,  # noqa: E402
                                            streaming_apply)
from bsvd_tpu_torch.archs.wnet_arch import (wnet_apply,  # noqa: E402
                                            wnet_apply_chunk)
from bsvd_tpu_torch.convert.torch_ckpt import to_jax_params  # noqa: E402
from bsvd_tpu_torch.data import build_dataset, data_util  # noqa: E402
from bsvd_tpu_torch.data import (jpeg_decode, png_decode,  # noqa: E402
                                 tiff_decode, utils_common)
from bsvd_tpu_torch.data.video_train_loader import (  # noqa: E402
    noisy_batch, synthetic_clips)
from bsvd_tpu_torch.metrics import calculate_psnr_float  # noqa: E402
from bsvd_tpu_torch.models.checkpoint import save_npz_params  # noqa: E402
from bsvd_tpu_torch.models.denoising_model import DenoisingModel  # noqa: E402
from bsvd_tpu_torch.models.optim import Adam  # noqa: E402
from bsvd_tpu_torch.models.seq_inference import (  # noqa: E402
    BlockStreamDenoiser, denoise_seq)
from bsvd_tpu_torch.nn.layers import conv2d, conv2d_weight_grad  # noqa: E402
from bsvd_tpu_torch.nn.shift import temporal_shift  # noqa: E402
from bsvd_tpu_torch.ops import _build  # noqa: E402
from bsvd_tpu_torch.ops import conv3x3 as conv3x3_mod  # noqa: E402
from bsvd_tpu_torch.ops import conv_chain as conv_chain_mod  # noqa: E402
from bsvd_tpu_torch.ops import conv_s2 as conv_s2_mod  # noqa: E402
from bsvd_tpu_torch.ops._pack import ConvWeights, act_mask  # noqa: E402
from bsvd_tpu_torch.ops.bibuffer_conv import (  # noqa: E402
    bibuffer_chain, bibuffer_chain_reference, bibuffer_conv,
    bibuffer_conv_reference, bibuffer_multi, bibuffer_multi_reference)
from bsvd_tpu_torch.ops.conv3x3 import (  # noqa: E402
    conv3x3, conv3x3_dw, conv3x3_dw_reference, conv3x3_reference, conv_ps,
    conv_ps_reference)
from bsvd_tpu_torch.ops.conv_chain import (conv_chain,  # noqa: E402
                                           conv_chain_add2_res,
                                           conv_chain_reference)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference  # noqa: E402
from bsvd_tpu_torch.ops.shift_conv import shift_conv_fused_v1  # noqa: E402
from bsvd_tpu_torch.profiler import count_params, device_profile  # noqa: E402
from bsvd_tpu_torch.test import test_pipeline  # noqa: E402
from bsvd_tpu_torch.train import train_loop, train_pipeline  # noqa: E402
from bsvd_tpu_torch.data import bmp_decode  # noqa: E402
from bsvd_tpu_torch.data import mp4_demux, nvdec, yuv  # noqa: E402
from bsvd_tpu_torch.utils import (jpeg_encode, lmdb_util,  # noqa: E402
                                  tb_events)
from bsvd_tpu_torch.utils.img_util import encode_png  # noqa: E402
from bsvd_tpu_torch.utils.logger import get_root_logger  # noqa: E402
from bsvd_tpu_torch.utils.options import (parse_options,  # noqa: E402
                                          yaml_load)
from tools import make_video_fixtures as mvf  # noqa: E402

SEED = 0
T, H, W = 10, 540, 960
SIGMA = 20 / 255
TRAIN_YML = os.path.join(ROOT, 'options', 'train', 'bsvd_c64_unblind.yml')
TEST_YML = os.path.join(ROOT, 'options', 'test', 'bsvd_c64.yml')
# the scratch root of the option files' experiments / results folders and
# of the PNG frame folders (made in main, removed at its end)
WORK = None


# phase 3's forward times and phase 2's per-unit sums, read by phase 14;
# phase 8's ms per step by amp, read by phase 15
MAIN_TIMING, KERNEL_SUMS, TRAIN_MS = {}, {}, {}
# seconds of each phase (run's ``timed``) and the run's start
PHASE_S, T_START = {}, None
# phase 12's bf16 train CLI validates with a PSNR metric (the train yml
# names none), so that its event files hold metrics/psnr
# nvidia-smi's name and power limit of the card (set in run)
SMI = None
TB_VAL_METRICS = ['val:metrics:psnr:type=calculate_psnr',
                  'val:metrics:psnr:crop_border=2',
                  'val:metrics:psnr:test_y_channel=false']


def shipped_net(path):
    """A shipped option file's network_g, its pretrain_ckpt dropped
    (random weights from SEED)."""
    net = yaml_load(path)['network_g']
    net.pop('pretrain_ckpt', None)
    return dict(net, seed=SEED)


# options/test/bsvd_c64.yml's network_g
C64 = shipped_net(TEST_YML)
# bf16 output rounding (2^-8 relative) plus bf16 rounding of summed inputs
# and of the chain's intermediate, relative to max(1, max|ref|)
BF16_TOL = 2 ** -6
# fp32 kernels vs the fp32 plain path: summation order only
FP32_TOL = 1e-4
KERNELS = {
    'conv3x3': (conv3x3, 'bsvd_tpu_torch/csrc/conv3x3.cu',
                'bsvd_tpu/ops/conv3x3.py:309', 'forward'),
    'conv_chain': (conv_chain, 'bsvd_tpu_torch/csrc/conv_chain.cu',
                   'bsvd_tpu/ops/conv_chain.py:213', 'forward'),
    'conv_s2': (conv_s2, 'bsvd_tpu_torch/csrc/conv_s2.cu',
                'bsvd_tpu/ops/conv_s2.py:155', 'forward'),
    'conv_ps': (conv_ps, 'bsvd_tpu_torch/csrc/conv_ps.cu',
                'bsvd_tpu/ops/conv3x3.py:797', 'forward'),
    'bibuffer_conv': (bibuffer_conv, 'bsvd_tpu_torch/csrc/bibuffer_conv.cu',
                      'bsvd_tpu/ops/bibuffer_conv.py:99', 'push'),
    'bibuffer_multi': (bibuffer_multi,
                       'bsvd_tpu_torch/csrc/bibuffer_conv.cu',
                       'bsvd_tpu/ops/bibuffer_conv.py:539', 'push_block'),
    'bibuffer_chain': (bibuffer_chain,
                       'bsvd_tpu_torch/csrc/bibuffer_conv.cu',
                       'bsvd_tpu/ops/bibuffer_conv.py:346', 'push'),
    'conv3x3_dw': (conv3x3_dw, 'bsvd_tpu_torch/csrc/conv3x3_dw.cu',
                   'bsvd_tpu/ops/conv3x3.py:476', 'train_step'),
    'shift_conv_fused_v1': (shift_conv_fused_v1,
                            'bsvd_tpu_torch/csrc/conv3x3.cu',
                            'bsvd_tpu/ops/shift_conv.py:174', 'forward'),
}
# the generation-1 entry launches K1: its sites and launches are K1's too,
# so the per-unit sums leave it out
ALIASES = ('shift_conv_fused_v1',)
NOT_STREAMED = ('conv3x3_dw', 'shift_conv_fused_v1')
# widths of a stage's MemCvBlocks in order (down0, down1, up2, up1): C64's
# chns[1], chns[2], chns[2], chns[1]
MEMCV_C = (128, 256, 256, 128)
PER_FORWARD = {'conv3x3': 16, 'conv_chain': 4, 'conv_s2': 4, 'conv_ps': 4,
               'shift_conv_fused_v1': 14}
# a c64 train step: the forward, then K7 for the 16 shift sites, 8 chain
# convs and 4 up convs, and K1 for the 4 chain intermediates
PER_TRAIN_STEP = dict(PER_FORWARD, conv3x3=20, conv3x3_dw=28)
# streaming: 24 frames pushed, push_block of 8, timing over 64 frames
STREAM_T, BLOCK_F, TIMED = 24, 8, 64
STAGES = 2


def chained(c, chain_max_c=None):
    """Whether a primed MemCvBlock of c channels runs as one K6 (the
    route of archs/streaming.py ``chain_route``, by ``CHAIN_MAX_C`` or the
    value given)."""
    return streaming.chain_route(c, chain_max_c)


def per_steady_push(chain_max_c=None):
    """Launches of a steady push: each stage runs its inc and outc chains,
    two stride-2 convs, two up convs and its MemCvBlocks, each one K6 or
    two K5 steps."""
    n6 = STAGES * sum(chained(c, chain_max_c) for c in MEMCV_C)
    return {'conv3x3': 0, 'conv_chain': 2 * STAGES, 'conv_s2': 2 * STAGES,
            'conv_ps': 2 * STAGES,
            'bibuffer_conv': 2 * (STAGES * len(MEMCV_C) - n6),
            'bibuffer_multi': 0, 'bibuffer_chain': n6, 'conv3x3_dw': 0,
            'shift_conv_fused_v1': 0}


# a chunk of the chunked protocol: the forward, and K1 at one frame at each
# of the 16 shift sites (the frame-0 recompute)
PER_CHUNK = dict(PER_FORWARD, conv3x3=32)
# phase 9: 25 frames at temp_psz 11 with 2 look-ahead frames (the train
# yml's validation), an 85-frame clip (Set8 / DAVIS) for the wall time;
# phase 10: two 25-frame folders
CHUNK_T, CHUNK_PSZ, CHUNK_FUTURE, LONG_T = 25, 11, 2, 85
EVAL_T = 13
PER_BLOCK = dict(per_steady_push(), bibuffer_conv=0,
                 bibuffer_multi=2 * STAGES * len(MEMCV_C), bibuffer_chain=0)
# the train slice: options/train/bsvd_c64_unblind.yml (batch 8 x 11 frames
# of 96 x 96); the parity step's reduced batch
TRAIN_N, TRAIN_T, TRAIN_HW = 8, 11, 96
GRAD_N, GRAD_T, GRAD_HW = 2, 5, 64
WARMUP, TIMED_STEPS = 5, 30
# the least time of a site: its operations at the dense bf16 tensor-core
# peak, or its bytes (each input read once, each output written once) at
# the HBM rate, whichever is longer (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def emit(obj):
    """One JSON line; a phase's line carries ``t_s``, the seconds since the
    run started."""
    if 'phase' in obj and T_START is not None:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def _run_module(args, timeout, cwd=ROOT, env=None):
    """``python -m <args>`` (from the repo root unless ``cwd``, the repo on
    the path; ``env`` entries added to the environment); its stdout
    lines."""
    env = dict(os.environ, **(env or {}))
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    res = subprocess.run([sys.executable, '-m', *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode:
        raise AssertionError(f'{args[0]} exited {res.returncode}: '
                             f'{res.stdout[-2000:]}{res.stderr[-3000:]}')
    return res.stdout.strip().splitlines()


def counts():
    return {k: v[0].launches for k, v in KERNELS.items()}


def delta_since(before):
    return {k: v - before[k] for k, v in counts().items()}


def reset_counts():
    for fn, _, _, _ in KERNELS.values():
        fn.launches = 0


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def wbytes(*cws):
    """Bytes of packed weights (bf16) and fp32 biases."""
    return sum(cw.w.numel() * 2 + cw.b.numel() * 4 for cw in cws)


def bound_ms(flops, n_bytes):
    """(operations ms, bytes ms) at the card's peaks."""
    return flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3


def rel_err(got, ref):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, max(1.0, ref.abs().max().item())


def psnr(got, ref):
    """PSNR in dB of ``got`` against ``ref``, both clipped to [0, 1]."""
    mse = ((got.float().clamp(0, 1) - ref.float().clamp(0, 1)) ** 2).mean()
    return 10 * math.log10(1 / mse.item()) if mse > 0 else float('inf')


# ---------------------------------------------------------------------------
# phase 2: every kernel variant of both paths, at its site shapes
# ---------------------------------------------------------------------------

# the route of phase 6's run by the chain where the push takes K5: one K6
# for every MemCvBlock (256 channels and under), in both modes
CHAIN_ROUTE = 256


def k6_on_path():
    """Whether a steady push runs K6 (some MemCvBlock chained)."""
    return any(chained(c) for c in MEMCV_C)


def _sites():
    """(kernel, variant, count, own, unit, make(g) -> (kernel call, plain
    call in fp32, plain call in bf16, exact, work)): ``count`` is the
    site's launches per ``unit`` of work of the bidirectional net
    ('forward': a 10-frame MIMO forward; 'push': a steady push; 'block': a
    steady push_block of 8), ``own`` the count at which the site enters its
    kernel's own sum (``count``; K6 off the push: one launch of each
    bidirectional site); ``exact`` flags
    the outputs (of a tuple) that must equal the plain version bit for bit;
    ``work`` holds the site's ``flops``, its input bytes ``in_bytes``,
    ``library``, one cuDNN call that does the site's conv arithmetic on
    inputs prepared beforehand (the shift and addend materialised, K4's
    shuffle left out), or None where the site is two convs (K2, K6), and
    ``pair``, those two convs' cuDNN calls, each on its input prepared
    beforehand (None elsewhere)."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4

    def conv(cin, cout, g):
        w = torch.randn((cout, cin, 3, 3), generator=g, device='cuda') * \
            math.sqrt(2 / (9 * cin))
        b = (torch.rand((cout,), generator=g, device='cuda') * 2 - 1) / \
            math.sqrt(9 * cin)
        return ConvWeights(w, b)

    def act_in(shape, g):
        return torch.rand(shape, generator=g, device='cuda').to(torch.bfloat16)

    def f32(*ts):
        return [None if t is None else t.float() for t in ts]

    def shifted(v, nt, shift):
        if shift == 'none':
            return v
        mode = 'TSM' if shift == 'tsm' else 'TSM_toFutureOnly'
        return temporal_shift(v.reshape(v.shape[0] // nt, nt, *v.shape[1:]),
                              8, mode).reshape(v.shape)

    def work(flops, inputs, cws, library, pair=None, twin=None):
        return {'flops': flops, 'in_bytes': nbytes(*inputs) + wbytes(*cws),
                'library': library, 'pair': pair, 'twin': twin}

    def lib_conv(v, cw, stride=1):
        """The library's conv of v, weights cast to bf16 once, here."""
        w, b = cw.w.to(torch.bfloat16), cw.b.to(torch.bfloat16)
        return lambda: conv2d(v, w, b, stride=stride)

    def lib_pair(v1, c1, v2, c2):
        """The library's two convs of a chain site, conv1 on v1 and conv2
        on v2 (the intermediate's shape), each prepared beforehand."""
        f1, f2 = lib_conv(v1, c1), lib_conv(v2, c2)
        return lambda: (f1(), f2())

    def k1(h, w, c, shift, add2, nt=T, cout=None):
        cout = cout or c

        def make(g):
            x = act_in((nt, h, w, c), g)
            x2 = act_in((nt, h, w, c), g) if add2 else None
            cw = conv(c, cout, g)
            kw = dict(t_len=nt, shift=shift, act='relu6')
            v = shifted(x if x2 is None else x + x2, nt, shift)
            return (lambda: conv3x3(x, cw, x2=x2, **kw),
                    lambda: conv3x3_reference(*f32(x), cw, x2=f32(x2)[0],
                                              **kw),
                    lambda: conv3x3_reference(x, cw, x2=x2, **kw), None,
                    work(2 * 9 * c * cout * nt * h * w, (x, x2), (cw,),
                         lib_conv(v, cw)))
        return make

    def k2(c, cres, cout, nt=T):
        def make(g):
            x = act_in((nt, H, W, c), g)
            c1, c2 = conv(c, 64, g), conv(64, cout, g)
            flops = 2 * 9 * (c * 64 + 64 * cout) * nt * H * W
            mid = act_in((nt, H, W, 64), g)
            if not cres:
                return (lambda: conv_chain(x, c1, None, c2, None, 'relu6',
                                           'relu6'),
                        lambda: conv_chain_reference(x.float(), c1, None, c2,
                                                     None, 'relu6', 'relu6'),
                        lambda: conv_chain_reference(x, c1, None, c2, None,
                                                     'relu6', 'relu6'), None,
                        work(flops, (x,), (c1, c2), None,
                             lib_pair(x, c1, mid, c2)))
            x2, xr = act_in(x.shape, g), act_in((nt, H, W, cres), g)
            return (lambda: conv_chain_add2_res(x, x2, xr, c1, None, c2, None,
                                                'relu6', 'none', 3),
                    lambda: conv_chain_reference(
                        x.float(), c1, None, c2, None, 'relu6', 'none',
                        x2=x2.float(), x_res=xr.float(), res_ch=3),
                    lambda: conv_chain_reference(
                        x, c1, None, c2, None, 'relu6', 'none', x2=x2,
                        x_res=xr, res_ch=3), None,
                    work(flops, (x, x2, xr), (c1, c2), None,
                         lib_pair(x + x2, c1, mid, c2)))
        return make

    def k3(h, w, c, cout, nt=T):
        def make(g):
            x = act_in((nt, h, w, c), g)
            cw = conv(c, cout, g)
            return (lambda: conv_s2(x, cw, act='relu6'),
                    lambda: conv_s2_reference(x.float(), cw, act='relu6'),
                    lambda: conv_s2_reference(x, cw, act='relu6'), None,
                    work(2 * 9 * c * cout * nt * -(-h // 2) * -(-w // 2),
                         (x,), (cw,),
                         lib_conv(x, cw, stride=2)))
        return make

    def k4(h, w, c, cout, nt=T):
        def make(g):
            x = act_in((nt, h, w, c), g)
            cw = conv(c, cout, g)
            return (lambda: conv_ps(x, cw),
                    lambda: conv_ps_reference(x.float(), cw),
                    lambda: conv_ps_reference(x, cw), None,
                    work(2 * 9 * c * cout * nt * h * w, (x,), (cw,),
                         lib_conv(x, cw)))
        return make

    def k5(h, w, c, causal, nf=None):
        """bibuffer_conv on one frame (nf None) or bibuffer_multi on nf."""
        def make(g):
            x = act_in((nf or 1, h, w, c), g)
            st = act_in((1, h, w, c), g)
            cw = conv(c, c, g)
            kw = dict(act='relu6', causal=causal)
            fn, ref = ((bibuffer_conv, bibuffer_conv_reference) if nf is None
                       else (bibuffer_multi, bibuffer_multi_reference))
            # the library conv runs on an input of the assembled one's shape
            return (lambda: fn(x, st, cw, **kw),
                    lambda: ref(*f32(x, st), cw, **kw),
                    lambda: ref(x, st, cw, **kw), (False, True),
                    work(2 * 9 * c * c * (nf or 1) * h * w, (x, st), (cw,),
                         lib_conv(x, cw)))
        return make

    def k6(h, w, c, causal):
        def make(g):
            x, s1, s2 = (act_in((1, h, w, c), g) for _ in range(3))
            c1, c2 = conv(c, c, g), conv(c, c, g)
            kw = dict(act='relu6', act2='relu6', causal=causal)

            def two_k5():
                """The route's other form: two K5 steps (y, s1', s2')."""
                y1, n1 = bibuffer_conv(x, s1, c1, act='relu6', causal=causal)
                y, n2 = bibuffer_conv(y1, s2, c2, act='relu6', causal=causal)
                return y, n1, n2
            return (lambda: bibuffer_chain(x, s1, s2, c1, None, c2, None,
                                           **kw),
                    lambda: bibuffer_chain_reference(*f32(x, s1, s2), c1,
                                                     None, c2, None, **kw),
                    lambda: bibuffer_chain_reference(x, s1, s2, c1, None, c2,
                                                     None, **kw),
                    (False, True, False),
                    work(2 * 2 * 9 * c * c * h * w, (x, s1, s2), (c1, c2),
                         None, lib_pair(x, c1, s2, c2), two_k5))
        return make

    def k7(hw, c, co, shift, add2):
        """K7 at a train site: NT = 8 clips x 11 frames of hw x hw."""
        def make(g):
            x = act_in((TRAIN_N * TRAIN_T, hw, hw, c), g)
            x2 = act_in(x.shape, g) if add2 else None
            # a cotangent of the MSE's scale (2^-10, exact in bf16)
            dz = (torch.randn((TRAIN_N * TRAIN_T, hw, hw, co), generator=g,
                              device='cuda') * 2 ** -10).to(torch.bfloat16)
            kw = dict(t_len=TRAIN_T, shift=shift)

            def cudnn_bf16():
                v = shifted(x if x2 is None else x + x2, TRAIN_T, shift)
                return conv2d_weight_grad(v, dz, (co, c, 3, 3))
            v = shifted(x if x2 is None else x + x2, TRAIN_T, shift)
            return (lambda: conv3x3_dw(x, dz, x2, **kw),
                    lambda: conv3x3_dw_reference(x, dz, x2, **kw),
                    cudnn_bf16, None,
                    work(2 * 9 * c * co * TRAIN_N * TRAIN_T * hw * hw,
                         (x, x2, dz), (),
                         lambda: conv2d_weight_grad(v, dz, (co, c, 3, 3))))
        return make

    def v1(h, w, c):
        def make(g):
            x = act_in((T, h, w, c), g)
            cw = conv(c, c, g)
            kw = dict(t_len=T, shift='tsm', act='relu6')
            v = shifted(x, T, 'tsm')
            return (lambda: shift_conv_fused_v1(x, cw, None, t_len=T),
                    lambda: conv3x3_reference(x.float(), cw, **kw),
                    lambda: conv3x3_reference(x, cw, **kw), None,
                    work(2 * 9 * c * c * T * h * w, (x,), (cw,),
                         lib_conv(v, cw)))
        return make

    fwd = [
        ('conv3x3', 'tsm_270x480_c128', 6, k1(h2, w2, 128, 'tsm', False)),
        ('conv3x3', 'tsm_add2_270x480_c128', 2, k1(h2, w2, 128, 'tsm', True)),
        ('conv3x3', 'tsm_135x240_c256', 8, k1(h4, w4, 256, 'tsm', False)),
        ('conv3x3', 'causal_270x480_c128', 0,
         k1(h2, w2, 128, 'causal', False)),
        ('conv3x3', 'causal_add2_270x480_c128', 0,
         k1(h2, w2, 128, 'causal', True)),
        ('conv3x3', 'causal_135x240_c256', 0,
         k1(h4, w4, 256, 'causal', False)),
        ('conv_chain', 'inc_540x960_4_64_64', 1, k2(4, 0, 64)),
        ('conv_chain', 'inc_540x960_64_64_64', 1, k2(64, 0, 64)),
        ('conv_chain', 'outc_res_540x960_64_64_64_xres4', 1, k2(64, 4, 64)),
        ('conv_chain', 'outc_res_540x960_64_64_3_xres64', 1, k2(64, 64, 3)),
        ('conv_s2', 's2_540x960_64_128', 2, k3(H, W, 64, 128)),
        ('conv_s2', 's2_270x480_128_256', 2, k3(h2, w2, 128, 256)),
        ('conv_ps', 'ps_135x240_256_512', 2, k4(h4, w4, 256, 512)),
        ('conv_ps', 'ps_270x480_128_256', 2, k4(h2, w2, 128, 256)),
        ('shift_conv_fused_v1', 'tsm_270x480_c128', 6, v1(h2, w2, 128)),
        ('shift_conv_fused_v1', 'tsm_135x240_c256', 8, v1(h4, w4, 256)),
    ]
    # the c64 train step's weight gradients (PER_TRAIN_STEP['conv3x3_dw'])
    hw2, hw4 = TRAIN_HW // 2, TRAIN_HW // 4
    train = [
        ('conv3x3_dw', 'inc1_96x96_4_64', 1, k7(TRAIN_HW, 4, 64, 'none',
                                                False)),
        ('conv3x3_dw', 'c64_96x96_64_64', 4, k7(TRAIN_HW, 64, 64, 'none',
                                                False)),
        ('conv3x3_dw', 'add2_96x96_64_64', 2, k7(TRAIN_HW, 64, 64, 'none',
                                                 True)),
        ('conv3x3_dw', 'outc2_96x96_64_3', 1, k7(TRAIN_HW, 64, 3, 'none',
                                                 False)),
        ('conv3x3_dw', 'tsm_48x48_c128', 6, k7(hw2, 128, 128, 'tsm', False)),
        ('conv3x3_dw', 'tsm_add2_48x48_c128', 2, k7(hw2, 128, 128, 'tsm',
                                                    True)),
        ('conv3x3_dw', 'ps_48x48_128_256', 2, k7(hw2, 128, 256, 'none',
                                                 False)),
        ('conv3x3_dw', 'tsm_24x24_c256', 8, k7(hw4, 256, 256, 'tsm', False)),
        ('conv3x3_dw', 'ps_24x24_256_512', 2, k7(hw4, 256, 512, 'none',
                                                 False)),
    ]
    assert sum(n for _, _, n, _ in train) == PER_TRAIN_STEP['conv3x3_dw']
    # the train step's 4 chain intermediates recomputed by K1 (64-channel
    # blocks)
    nt_train = TRAIN_N * TRAIN_T
    train += [
        ('conv3x3', 'chain_inc_96x96_4_64', 2,
         k1(TRAIN_HW, TRAIN_HW, 4, 'none', False, nt_train, 64)),
        ('conv3x3', 'chain_add2_96x96_64_64', 2,
         k1(TRAIN_HW, TRAIN_HW, 64, 'none', True, nt_train, 64)),
    ]
    assert sum(n for k, _, n, _ in train if k == 'conv3x3') == \
        PER_TRAIN_STEP['conv3x3'] - PER_FORWARD['conv3x3']
    # per-frame streaming sites: a push's MemCvBlocks of each width (4: two
    # a stage) run as one K6 or two K5 steps by CHAIN_MAX_C; the other
    # route at each width is timed with count 0
    n_at = {c: STAGES * MEMCV_C.count(c) for c in set(MEMCV_C)}

    def n5(c):
        return 0 if chained(c) else 2 * n_at[c]

    def n6(c):
        return n_at[c] if chained(c) else 0
    stream = [
        ('bibuffer_conv', 'bidir_135x240_c256', n5(256),
         k5(h4, w4, 256, False)),
        ('bibuffer_conv', 'causal_135x240_c256', 0, k5(h4, w4, 256, True)),
        ('bibuffer_conv', 'bidir_270x480_c128', n5(128),
         k5(h2, w2, 128, False)),
        ('bibuffer_conv', 'causal_270x480_c128', 0, k5(h2, w2, 128, True)),
        ('bibuffer_chain', 'bidir_270x480_c128', n6(128),
         k6(h2, w2, 128, False)),
        ('bibuffer_chain', 'causal_270x480_c128', 0, k6(h2, w2, 128, True)),
        ('bibuffer_chain', 'bidir_135x240_c256', n6(256),
         k6(h4, w4, 256, False)),
        ('bibuffer_chain', 'causal_135x240_c256', 0, k6(h4, w4, 256, True)),
        ('conv3x3', 'drain_270x480_c128', 0, k1(h2, w2, 128, 'none', False,
                                                nt=1)),
        ('conv3x3', 'drain_135x240_c256', 0, k1(h4, w4, 256, 'none', False,
                                                nt=1)),
        ('conv_chain', 'inc_540x960_4_64_64', 1, k2(4, 0, 64, nt=1)),
        ('conv_chain', 'inc_540x960_64_64_64', 1, k2(64, 0, 64, nt=1)),
        ('conv_chain', 'outc_res_540x960_64_64_64_xres3', 1,
         k2(64, 3, 64, nt=1)),
        ('conv_chain', 'outc_res_540x960_64_64_3_xres3', 1,
         k2(64, 3, 3, nt=1)),
        ('conv_s2', 's2_540x960_64_128', 2, k3(H, W, 64, 128, nt=1)),
        ('conv_s2', 's2_270x480_128_256', 2, k3(h2, w2, 128, 256, nt=1)),
        ('conv_ps', 'ps_135x240_256_512', 2, k4(h4, w4, 256, 512, nt=1)),
        ('conv_ps', 'ps_270x480_128_256', 2, k4(h2, w2, 128, 256, nt=1)),
    ]
    block = [
        ('bibuffer_multi', f'bidir_f{BLOCK_F}_270x480_c128', n_at[128] * 2,
         k5(h2, w2, 128, False, BLOCK_F)),
        ('bibuffer_multi', f'bidir_f{BLOCK_F}_135x240_c256', n_at[256] * 2,
         k5(h4, w4, 256, False, BLOCK_F)),
        ('bibuffer_multi', f'causal_f{BLOCK_F}_270x480_c128', 0,
         k5(h2, w2, 128, True, BLOCK_F)),
        ('bibuffer_multi', f'causal_f{BLOCK_F}_135x240_c256', 0,
         k5(h4, w4, 256, True, BLOCK_F)),
    ]
    per_push = per_steady_push()
    assert all(sum(n for k, _, n, _ in stream if k == name) == per_push[name]
               for name in ('bibuffer_conv', 'bibuffer_chain', 'conv_chain',
                            'conv_s2', 'conv_ps'))
    assert sum(n for _, _, n, _ in block) == PER_BLOCK['bibuffer_multi']
    def own(k, v, n):
        if k != 'bibuffer_chain' or k6_on_path():
            return n
        return 0 if v.startswith('causal') else 1
    return ([(k, v, n, n, 'forward', m) for k, v, n, m in fwd]
            + [(k, v, n, own(k, v, n), 'push', m) for k, v, n, m in stream]
            + [(k, v, n, n, 'push_block', m) for k, v, n, m in block]
            + [(k, v, n, n, 'train_step', m) for k, v, n, m in train])


def _check_site(name, got, ref, exact):
    """Max |diff| and tolerance of the outputs compared within tolerance;
    raises if one is outside it or an exact output differs."""
    if exact is None:
        got, ref, exact = (got,), (ref,), (False,)
    worst, tol = 0.0, 0.0
    for g, r, ex in zip(got, ref, exact):
        if g.shape != r.shape:
            raise AssertionError(f'{name}: shape {tuple(g.shape)} != '
                                 f'{tuple(r.shape)}')
        if ex:
            if not torch.equal(g.float(), r.float()):
                raise AssertionError(f'{name}: state copy differs')
            continue
        err, scale = rel_err(g, r)
        if not err <= BF16_TOL * scale:
            raise AssertionError(f'{name}: max|diff| {err} > '
                                 f'{BF16_TOL * scale}')
        if err >= worst:
            worst, tol = err, BF16_TOL * scale
    return worst, tol


def phase_kernels():
    """Per kernel: max err; ms, plain_ms, library_ms, library_pair_ms and
    bound_ms at the counts of its unit (the KERNELS table; K6 off the push:
    one launch of each bidirectional site), library_ms (library_pair_ms) None where a site of
    the unit has no one-call (two-call) library counterpart; bound_by the
    resource whose time dominates the summed bound. Also the kernel and
    plain ms of one steady push and of one push_block over all kernels."""
    g = torch.Generator(device='cuda').manual_seed(SEED)
    summary = {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
                   'library_ms': 0.0, 'library_pair_ms': 0.0,
                   'bound_ms': 0.0, 'ops_ms': 0.0, 'bytes_ms': 0.0}
               for k in KERNELS}
    per_unit = {u: {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'flops': 0}
                for u in ('forward', 'push', 'push_block', 'train_step')}
    for kernel, variant, count, own, unit, make in _sites():
        run, plain32, plain_bf16, exact, wk = make(g)
        got = run()
        torch.cuda.synchronize()
        ref = plain32()
        err, tol = _check_site(f'{kernel}/{unit}/{variant}', got, ref, exact)
        del ref
        ms = median_ms(run)
        plain_ms = median_ms(plain_bf16)
        lib_ms = median_ms(wk['library']) if wk['library'] else None
        pair_ms = median_ms(wk['pair']) if wk['pair'] else None
        twin = {}
        if wk['twin']:
            # K6 against the two K5 steps the route takes instead: bit for
            # bit (a report) and time
            other = wk['twin']()
            twin = {'equals_two_k5': {k: torch.equal(a, b) for k, a, b in
                                      zip(('y', 's1n', 's2n'), got, other)},
                    'two_k5_ms': median_ms(wk['twin'])}
            del other
        outs = got if isinstance(got, tuple) else (got,)
        n_bytes = wk['in_bytes'] + nbytes(*outs)
        ops_ms, bytes_ms = bound_ms(wk['flops'], n_bytes)
        bound = max(ops_ms, bytes_ms)
        emit({'phase': 'kernel', 'kernel': kernel, 'variant': variant,
              'per': unit, 'shape_out': list(outs[0].shape),
              'max_abs_err': err, 'tol': tol, 'exact_states': bool(exact),
              'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
              'library_pair_ms': pair_ms,
              'flops': wk['flops'], 'bytes': n_bytes, 'bound_ms': bound,
              'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
              'tflops': wk['flops'] / ms / 1e9, 'count': count, **twin})
        s = summary[kernel]
        s['max_abs_err'] = max(s['max_abs_err'], err)
        if unit == KERNELS[kernel][3]:
            s['ms'] += own * ms
            s['plain_ms'] += own * plain_ms
            s['bound_ms'] += own * bound
            s['ops_ms'] += own * ops_ms
            s['bytes_ms'] += own * bytes_ms
            for key, t in (('library_ms', lib_ms),
                           ('library_pair_ms', pair_ms)):
                if s[key] is not None and own:
                    s[key] = None if t is None else s[key] + own * t
        if kernel not in ALIASES:
            per_unit[unit]['ms'] += count * ms
            per_unit[unit]['plain_ms'] += count * plain_ms
            per_unit[unit]['bound_ms'] += count * bound
            per_unit[unit]['flops'] += count * wk['flops']
        del got, outs
        torch.cuda.empty_cache()
    emit({'phase': 'kernel_sums', 'per_unit': per_unit})
    KERNEL_SUMS.update(per_unit)
    for s in summary.values():
        if not s['library_pair_ms']:
            s['library_pair_ms'] = None
        s['bound_by'] = ('operations' if s.pop('ops_ms') >= s.pop('bytes_ms')
                         else 'bytes')
    return summary


# ---------------------------------------------------------------------------
# phase 3: the MIMO main path
# ---------------------------------------------------------------------------

def _clips(rng, n, t_len=T):
    """Smooth synthetic clean clips (t_len, 3, H, W) in [0, 1] and their
    noisy versions at SIGMA."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(n):
        f = rng.uniform(0.005, 0.03, size=(3, 2)).astype(np.float32)
        ph = rng.uniform(0, 6.28, size=(3, t_len)).astype(np.float32)
        clean = np.empty((t_len, 3, H, W), np.float32)
        for t in range(t_len):
            for c in range(3):
                clean[t, c] = 0.5 + 0.4 * np.sin(f[c, 0] * yy + f[c, 1] * xx
                                                 + ph[c, t])
        noisy = clean + SIGMA * rng.standard_normal(clean.shape,
                                                    dtype=np.float32)
        out.append((clean, noisy.astype(np.float32)))
    return out


class _NoConv2d:
    """Make F.conv2d raise while the main path runs."""

    def __enter__(self):
        self.orig = F.conv2d

        def refuse(*a, **k):
            raise AssertionError('F.conv2d called on the kernel path')
        F.conv2d = refuse

    def __exit__(self, *exc):
        F.conv2d = self.orig


def _check_out(out, clip):
    if out.shape != clip.shape:
        raise AssertionError(f'output shape {out.shape} != {clip.shape}')
    if not np.isfinite(out).all():
        raise AssertionError('non-finite output')
    if out.min() < 0 or out.max() > 1:
        raise AssertionError('output outside [0, 1]')


def phase_main(clips):
    nets = {mode: build_network(dict(C64, shift_mode=mode))
            for mode in ('TSM', 'TSM_toFutureOnly')}
    outs = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _NoConv2d():
        for mode, net in nets.items():
            before = counts()
            t0 = time.perf_counter()
            outs[mode] = [denoise_seq(net, None, noisy, noise_sigma=SIGMA,
                                      compute_dtype=torch.bfloat16)
                          for _, noisy in clips]
            wall = (time.perf_counter() - t0) / len(clips)
            delta = delta_since(before)
            for k in KERNELS:
                n = PER_FORWARD.get(k, 0)
                if delta[k] != n * len(clips):
                    raise AssertionError(f'{mode}: {k} launched {delta[k]} '
                                         f'times in {len(clips)} forwards, '
                                         f'expected {n} each')
            for (clean, _), out in zip(clips, outs[mode]):
                _check_out(out, clean)
            emit({'phase': 'main', 'shift_mode': mode, 'clips': len(clips),
                  'launches_per_forward': {k: v // len(clips)
                                           for k, v in delta.items()},
                  'denoise_seq_s_per_clip': wall})
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # device time of one 10-frame forward, input resident on the card
    for mode, net in nets.items():
        x = torch.from_numpy(clips[0][1]).cuda().to(torch.bfloat16)
        x = torch.cat([x, torch.full_like(x[:, :1], SIGMA)], dim=1)
        x = x.permute(0, 2, 3, 1)[None].contiguous()
        p = net.prepared(x.device, torch.bfloat16)
        with torch.no_grad():
            ms = median_ms(lambda: wnet_apply(p, x, net.cfg), reps=5)
        emit({'phase': 'main_timing', 'shift_mode': mode,
              'forward_ms_median_of_5': ms, 'frames': T,
              'peak_allocated_gb': peak_gb})
        MAIN_TIMING[mode] = {'forward_ms_median_of_5': ms,
                             'peak_allocated_gb': peak_gb}
    return nets, outs, launches


# ---------------------------------------------------------------------------
# phase 4: whole-net parity
# ---------------------------------------------------------------------------

def phase_parity(nets, clips, outs):
    net = nets['TSM']
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 4, 128, 224, 4))
                         .astype(np.float32))
    with torch.no_grad():
        ref = wnet_apply(net.prepared('cpu', torch.float32), x, net.cfg)
        plain16 = wnet_apply(net.prepared('cpu', torch.bfloat16),
                             x.to(torch.bfloat16), net.cfg)
        got32 = wnet_apply(net.prepared('cuda', torch.float32), x.cuda(),
                           net.cfg).cpu()
        got16 = wnet_apply(net.prepared('cuda', torch.bfloat16),
                           x.cuda().to(torch.bfloat16), net.cfg).cpu()
    err32, scale = rel_err(got32, ref)
    # random weights make bf16 drift far from fp32 over 32 convs; the bf16
    # kernel path must drift no more than the plain bf16 path (1 dB)
    psnr16, plain_psnr16 = psnr(got16, ref), psnr(plain16, ref)
    emit({'phase': 'parity_reduced', 'shape': list(x.shape),
          'fp32_kernels_vs_cpu_plain_max_abs_err': err32,
          'tol': FP32_TOL * scale,
          'bf16_kernels_vs_cpu_plain_max_abs_err': rel_err(got16, ref)[0],
          'bf16_kernels_vs_fp32_psnr_db': psnr16,
          'bf16_cpu_plain_vs_fp32_psnr_db': plain_psnr16})
    if not err32 <= FP32_TOL * scale:
        raise AssertionError(f'fp32 kernel path vs plain: {err32}')
    if not psnr16 > plain_psnr16 - 1.0:
        raise AssertionError(f'bf16 kernel path {psnr16} dB vs fp32, plain '
                             f'bf16 path {plain_psnr16} dB')

    clean, noisy = clips[0]
    out32 = denoise_seq(net, None, noisy, noise_sigma=SIGMA,
                        compute_dtype=torch.float32)
    _check_out(out32, clean)
    out16 = outs['TSM'][0]
    emit({'phase': 'parity_540p', 'bf16_vs_fp32_max_abs_err':
          float(np.abs(out16 - out32).max()),
          'bf16_vs_fp32_psnr_db': psnr(torch.from_numpy(out16),
                                       torch.from_numpy(out32))})
    return out32


# ---------------------------------------------------------------------------
# phase 5: the streaming main path
# ---------------------------------------------------------------------------

def expected_step(p, t_len, causal):
    """Launches of streaming step p (0-based; p >= t_len are the flush's
    drain steps) over a t_len-frame clip, by archs/streaming.py's rule,
    derived here from frame indices alone. Stage s's temporal conv k (8s ..
    8s+7: down0, down1, up2, up1, two each) reads frame p - k at step p
    and holds frame p - k - 1: it outputs iff that frame exists, through
    K5 if its input exists too (steady) and K1 if not (drain). A
    MemCvBlock that the route chains (``chained``) runs as one K6 when
    both its convs are steady. The causal net has no delay: every
    site runs steady on every valid frame."""
    c = dict.fromkeys(KERNELS, 0)

    def ok(j):
        return 0 <= j < t_len

    for s in range(STAGES):
        if causal:
            if ok(p):
                for k, n in per_steady_push().items():
                    c[k] += n // STAGES
            continue
        base = 8 * s
        q = p - base                       # frame at the stage's input
        if ok(q):                          # inc, down0's stride-2 conv
            c['conv_chain'] += 1
            c['conv_s2'] += 1
        for j, width in enumerate(MEMCV_C):
            k1 = base + 2 * j
            if chained(width) and all(ok(p - k1 - d) for d in range(3)):
                c['bibuffer_chain'] += 1
                continue
            for k in (k1, k1 + 1):
                if ok(p - k - 1):
                    c['bibuffer_conv' if ok(p - k) else 'conv3x3'] += 1
        if ok(q - 2):                      # down1's stride-2 conv
            c['conv_s2'] += 1
        if ok(q - 6):                      # up2's conv + shuffle
            c['conv_ps'] += 1
        if ok(q - 8):                      # up1's conv + shuffle, outc
            c['conv_ps'] += 1
            c['conv_chain'] += 1
    return c


def _stream_input(noisy):
    """(T, 3, H, W) numpy -> (T, 1, H, W, 4) bf16 frames on the card."""
    x = torch.from_numpy(noisy).cuda().to(torch.bfloat16)
    x = torch.cat([x, torch.full_like(x[:, :1], SIGMA)], dim=1)
    return x.permute(0, 2, 3, 1)[:, None].contiguous()


def _state_bytes(state):
    total = 0
    for st in state:
        for v in st.values():
            for node in (v if isinstance(v, list) else [v]):
                t = node['packed'] if 'packed' in node else node['buf']
                total += t.numel() * t.element_size()
    return total


def _time_per_frame(sd, x, block):
    """Best of 3 host-clock ms per frame over TIMED frames resident on the
    card, ending in a synchronize (push, or push_block of BLOCK_F)."""
    best = float('inf')
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if block:
            for k in range(0, TIMED, BLOCK_F):
                i = k % STREAM_T
                sd.push_block(x[i:i + BLOCK_F])
        else:
            for k in range(TIMED):
                sd.push(x[k % STREAM_T])
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / TIMED)
    return best * 1e3


def _profile_pushes(sd, x, n=16):
    """The device profile of n steady pushes."""
    def run():
        for k in range(n):
            sd.push(x[k % STREAM_T])
        torch.cuda.synchronize()
    prof = device_profile(run, n, 'steady_pushes')
    return {'pushes': n,
            'window_ms_per_push': prof['window_ms_per_unit'],
            'device_busy_ms_per_push': prof['device_busy_ms_per_unit'],
            'idle_share': prof['idle_share'],
            'top_device_ms_per_push': prof['top_device_ms_per_unit'][:9]}


def phase_stream(nets, clip):
    """Returns the launches of the checked main-path runs."""
    clean, noisy = clip
    x = _stream_input(noisy)
    xm = x[:, 0][None]                           # (1, T, H, W, 4) for MIMO
    launches = dict.fromkeys(KERNELS, 0)
    for mode, net in nets.items():
        causal = 'toFutureOnly' in mode
        cfg = net.cfg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9
        sd = StreamDenoiser(net, None, batch=1, height=H, width=W,
                            dtype=torch.bfloat16)
        state_gb = _state_bytes(sd.state) / 1e9
        lat = sd.latency
        reset_counts()
        steps, outs = [], []
        with _NoConv2d():
            for i in range(STREAM_T):
                before = counts()
                out = sd.push(x[i])
                steps.append(delta_since(before))
                if out is not None:
                    outs.append(out)
            before = counts()
            outs += sd.flush()
            drain = delta_since(before)
        for k, v in counts().items():
            launches[k] += v
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        for p, got in enumerate(steps):
            if got != expected_step(p, STREAM_T, causal):
                raise AssertionError(f'{mode}: push {p} launched {got}, '
                                     f'expected {expected_step(p, STREAM_T, causal)}')
            if lat <= p and got != per_steady_push():
                raise AssertionError(f'{mode}: steady push {p}: {got}')
        want = dict.fromkeys(KERNELS, 0)
        for p in range(STREAM_T, STREAM_T + lat):
            for k, v in expected_step(p, STREAM_T, causal).items():
                want[k] += v
        if drain != want:
            raise AssertionError(f'{mode}: flush launched {drain}, expected '
                                 f'{want}')
        if len(outs) != STREAM_T:
            raise AssertionError(f'{mode}: {len(outs)} outputs for '
                                 f'{STREAM_T} frames')
        y = torch.stack(outs, dim=1)
        if not torch.isfinite(y).all():
            raise AssertionError(f'{mode}: non-finite streaming output')

        with torch.no_grad():
            ref32 = wnet_apply(net.prepared('cuda', torch.float32),
                               xm.float(), cfg)
            mimo16 = wnet_apply(net.prepared('cuda', torch.bfloat16), xm,
                                cfg)
        psnr_stream, psnr_mimo = psnr(y, ref32), psnr(mimo16, ref32)
        if not psnr_stream > psnr_mimo - 1.0:
            raise AssertionError(f'{mode}: bf16 streaming {psnr_stream} dB vs'
                                 f' fp32 MIMO, bf16 MIMO {psnr_mimo} dB')

        # a steady push_block of BLOCK_F frames (the first lat by push)
        sd.reset()
        for i in range(lat):
            sd.push(x[i])
        reset_counts()
        with _NoConv2d():
            blk = sd.push_block(x[lat:lat + BLOCK_F])
        block = counts()
        for k, v in block.items():
            launches[k] += v
        if block != PER_BLOCK:
            raise AssertionError(f'{mode}: push_block launched {block}')
        yb = torch.stack(blk, dim=1)                 # frames 0 .. BLOCK_F-1
        psnr_block = psnr(yb, ref32[:, :BLOCK_F])
        psnr_mimo_b = psnr(mimo16[:, :BLOCK_F], ref32[:, :BLOCK_F])
        if not psnr_block > psnr_mimo_b - 1.0:
            raise AssertionError(f'{mode}: push_block {psnr_block} dB, bf16 '
                                 f'MIMO {psnr_mimo_b} dB')
        del ref32, mimo16, y, yb, outs, blk

        sd.reset()
        for i in range(lat + 4):
            sd.push(x[i % STREAM_T])
        push_ms = _time_per_frame(sd, x, block=False)
        block_ms = _time_per_frame(sd, x, block=True)
        prof = _profile_pushes(sd, x)
        emit({'phase': 'stream', 'shift_mode': mode, 'latency': lat,
              'frames': STREAM_T, 'launches_fill_steady': steps,
              'launches_flush': drain, 'launches_push_block': block,
              'psnr_db_vs_fp32_mimo': {'stream_bf16': psnr_stream,
                                       'mimo_bf16': psnr_mimo,
                                       'push_block_bf16': psnr_block,
                                       'mimo_bf16_first_block': psnr_mimo_b},
              'push_ms_per_frame': push_ms,
              f'push_block{BLOCK_F}_ms_per_frame': block_ms,
              'state_gb': state_gb, 'allocated_before_gb': before_gb,
              'peak_allocated_gb': peak_gb,
              'profile': prof})
        del sd
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: streaming parity
# ---------------------------------------------------------------------------

def phase_stream_parity(nets, clips, outs, out32):
    """fp32 streaming kernels against fp32 MIMO kernels on a reduced clip,
    by the port's MemCvBlock route and by the other one; denoise_seq(mode=
    'streaming') of a 540p clip against mode='mimo'. Returns the launches
    of the denoise_seq run (a main path) and those of the other-route runs
    (off it)."""
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 20, 128, 224, 4))
                         .astype(np.float32)).cuda()
    # the route the main path does not take: K6 for every MemCvBlock up to
    # CHAIN_ROUTE channels, or two K5 steps for every one
    main_route = streaming.CHAIN_MAX_C
    other_route = CHAIN_ROUTE if main_route < CHAIN_ROUTE else 0
    off_path = dict.fromkeys(KERNELS, 0)
    for mode, net in nets.items():
        p = net.prepared('cuda', torch.float32)
        with torch.no_grad():
            ref = wnet_apply(p, x, net.cfg)
        for route in (main_route, other_route):
            streaming.CHAIN_MAX_C = route
            try:
                reset_counts()
                with torch.no_grad():
                    got = streaming_apply(p, x, net.cfg)
                run = counts()
            finally:
                streaming.CHAIN_MAX_C = main_route
            err, scale = rel_err(got, ref)
            emit({'phase': 'stream_parity_fp32', 'shift_mode': mode,
                  'chain_max_c': route, 'shape': list(x.shape),
                  'max_abs_err': err, 'tol': FP32_TOL * scale,
                  'launches': run})
            if not err <= FP32_TOL * scale:
                raise AssertionError(f'{mode}, CHAIN_MAX_C {route}: fp32 '
                                     f'streaming vs MIMO: {err}')
            if route == other_route:
                for k, v in run.items():
                    off_path[k] += v
    took = 'bibuffer_chain' if other_route else 'bibuffer_conv'
    if not off_path[took] > 0:
        raise AssertionError(f'the other route (CHAIN_MAX_C {other_route}) '
                             f'never launched {took}')

    clean, noisy = clips[0]
    reset_counts()
    with _NoConv2d():
        s16 = denoise_seq(nets['TSM'], None, noisy, noise_sigma=SIGMA,
                          mode='streaming', compute_dtype=torch.bfloat16)
    seq = counts()
    _check_out(s16, clean)
    to_t = torch.from_numpy
    psnr_s, psnr_m = psnr(to_t(s16), to_t(out32)), psnr(to_t(outs['TSM'][0]),
                                                        to_t(out32))
    emit({'phase': 'denoise_seq_streaming', 'frames': T,
          'psnr_db_vs_fp32_mimo': {'streaming_bf16': psnr_s,
                                   'mimo_bf16': psnr_m},
          'launches': seq})
    if not psnr_s > psnr_m - 1.0:
        raise AssertionError(f"denoise_seq(mode='streaming') {psnr_s} dB, "
                             f"mode='mimo' {psnr_m} dB")
    return seq, off_path


# ---------------------------------------------------------------------------
# phase 6a: a whole clip over the device budget (the streaming route)
# ---------------------------------------------------------------------------

def phase_over_budget(nets, clips, outs, out32):
    """``denoise_seq`` of phase 4's 10-frame 540p clip in bf16 with
    ``seq_inference._memory_budget`` lowered below the clip's whole-clip
    activations: the streaming route runs (its warning logged, K5 / K10
    and K1 / K3 / K4 at one frame launched), held to the whole-clip fp32
    output by phase 4's PSNR rule (within 1 dB of the bf16 MIMO output's
    PSNR). Returns its launches."""
    import bsvd_tpu_torch.models.seq_inference as seq_mod
    net = nets['TSM']
    clean, noisy = clips[0]
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger('bsvd_tpu_torch')
    real = seq_mod._memory_budget
    per_clip = T * H * W * 256 * 2          # the gate's bf16 estimate
    seq_mod._memory_budget = lambda device, frac=0.8: per_clip / 2
    logger.addHandler(handler)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _NoConv2d():
            got = denoise_seq(net, None, noisy, noise_sigma=SIGMA,
                              compute_dtype=torch.bfloat16)
        wall = time.perf_counter() - t0
        launches = counts()
    finally:
        seq_mod._memory_budget = real
        logger.removeHandler(handler)
    _check_out(got, clean)
    db = psnr(torch.from_numpy(got), torch.from_numpy(out32))
    mimo_db = psnr(torch.from_numpy(outs['TSM'][0]), torch.from_numpy(out32))
    rec = {'phase': 'over_budget', 'frames': T, 'hw': [H, W],
           'budget_gb': per_clip / 2 / 1e9,
           'whole_clip_estimate_gb': per_clip / 1e9,
           'warned': any('streaming route' in m for m in seen),
           'psnr_db_vs_fp32_mimo': db, 'bf16_mimo_psnr_db': mimo_db,
           'launches': launches, 'wall_s': wall,
           'ms_per_frame': wall * 1e3 / T}
    emit(rec)
    used = ('bibuffer_conv', 'conv3x3', 'conv_s2', 'conv_ps')
    if not rec['warned'] or not db > mimo_db - 1.0 or \
            not all(launches[k] > 0 for k in used):
        raise AssertionError(f'over-budget whole clip: {rec}')
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8: the train slice
# ---------------------------------------------------------------------------

def _train_opt(t_len, amp=False, ema_decay=0):
    """options/train/bsvd_c64_unblind.yml through ``parse_options``, with
    ``num_segments`` the clip length and train.fp16 / train.ema_decay
    forced."""
    opt, _ = parse_options(WORK, is_train=True, cmd=[
        '-opt', TRAIN_YML, '--force_yml', f'network_g:num_segments={t_len}',
        f'train:fp16={str(amp).lower()}', f'train:ema_decay={ema_decay}'])
    return opt


def _train_batch(rng, n, t_len, hw):
    """A train batch through the ported augment and noise code (noise_ival
    [5, 55], noise_shape N) from seeded synthetic uint8 clips."""
    return noisy_batch(synthetic_clips(rng, n, t_len, hw, hw), rng, [5, 55],
                       'N')


class _SharedMasks:
    """Records the activation masks of one backward (in call order) and
    hands them to a later backward on the other device, counting where
    that device's own mask differs."""

    MODULES = (conv3x3_mod, conv_chain_mod, conv_s2_mod)

    def __init__(self):
        self.masks, self.flips, self.fn = [], 0, None

    def _record(self, g, y, act):
        m = act_mask(y, act)
        self.masks.append(m)
        return g if m is None else g * m

    def _replay(self, g, y, act):
        m = self.masks.pop(0)
        if m is None:
            return g
        m = m.to(g.device, g.dtype)
        self.flips += int((act_mask(y, act) != m).sum())
        return g * m

    def record(self):
        self.fn = self._record
        return self

    def replay(self):
        self.fn = self._replay
        return self

    def __enter__(self):
        self.saved = [mod.masked for mod in self.MODULES]
        for mod in self.MODULES:
            mod.masked = self.fn

    def __exit__(self, *exc):
        for mod, fn in zip(self.MODULES, self.saved):
            mod.masked = fn


def _max_rel(got, ref):
    ref = ref.detach().float().cpu()
    err = (got.detach().float().cpu() - ref).abs().max().item()
    return err / max(ref.abs().max().item(), 1e-30)


def phase_train_grad():
    """One fp32 step of the full-width net, card against CPU."""
    opt = _train_opt(GRAD_T)
    batch = _train_batch(np.random.default_rng(SEED + 4), GRAD_N, GRAD_T,
                         GRAD_HW)
    card = DenoisingModel(copy.deepcopy(opt), device='cuda')
    cpu = DenoisingModel(copy.deepcopy(opt), device='cpu')
    before = {n: p.detach().clone() for n, p in cpu.net.named_parameters()}
    masks = _SharedMasks()
    card.feed_data(batch)
    with _NoConv2d(), masks.record():
        card.optimize_parameters(1)
    cpu.feed_data(batch)
    with masks.replay():
        cpu.optimize_parameters(1)
    # the parameters after the step: the CPU optimizer fed the card's grads
    named = dict(card.net.named_parameters())
    ref = [(n, p.requires_grad_(True)) for n, p in before.items()]
    for n, p in ref:
        p.grad = named[n].grad.cpu()
    Adam(ref, cpu.lr_schedule, betas=opt['train']['optim_g']['betas']).step()
    loss, ref_loss = card.get_current_log()['l_pix'], \
        cpu.get_current_log()['l_pix']
    errs = {'loss': abs(loss - ref_loss) / abs(ref_loss)}
    cpu_named = dict(cpu.net.named_parameters())
    grad_errs = {n: _max_rel(p.grad, cpu_named[n].grad)
                 for n, p in named.items()}
    param_errs = {n: _max_rel(named[n], p) for n, p in ref}
    worst_g = max(grad_errs, key=grad_errs.get)
    worst_p = max(param_errs, key=param_errs.get)
    emit({'phase': 'train_grad', 'batch': [GRAD_N, GRAD_T, GRAD_HW, GRAD_HW],
          'loss': loss, 'loss_rel_err': errs['loss'],
          'grad_max_rel_err': [worst_g, grad_errs[worst_g]],
          'param_max_rel_err': [worst_p, param_errs[worst_p]],
          'tensors': len(grad_errs), 'mask_flips': masks.flips,
          'tol': FP32_TOL})
    if not math.isfinite(loss):
        raise AssertionError('non-finite loss on the card')
    for what, e in [('loss', errs['loss'])] + [
            (f'grad {n}', e) for n, e in grad_errs.items()] + [
            (f'param {n}', e) for n, e in param_errs.items()]:
        if not e <= FP32_TOL:
            raise AssertionError(f'train step on the card vs the CPU: {what} '
                                 f'max rel err {e}')


def _kernel_group(name):
    n = name.lower()
    if 'conv3x3_dw' in n:
        return 'K7 conv3x3_dw'
    if 'conv_ps' in n:
        return 'K4 conv_ps'
    if 'bsvd::conv3x3_' in n:
        return 'K1 conv3x3'
    for key, group in (('bibuffer', 'K5/K6'), ('conv_chain', 'K2 conv_chain'),
                       ('conv_s2', 'K3 conv_s2'), ('dgrad', 'cuDNN dgrad'),
                       ('wgrad', 'cuDNN wgrad'), ('reduce_kernel', 'sums'),
                       ('copy', 'copies'), ('elementwise', 'elementwise')):
        if key in n:
            return group
    return 'other'


def _time_steps(model, steps, first_iter, batch=None):
    """Host-clock ms per step over ``steps`` steps (synchronised at both
    ends), each after ``feed_data(batch)`` where a batch is given, and the
    steps' losses read back after the timing."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        if batch is not None:
            model.feed_data(batch)
        model.optimize_parameters(first_iter + i)
        losses.append(model.log_dict['l_pix'])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, [float(v) for v in
                                                      losses]


def _profile_steps(model, n, first_iter):
    """The device profile of n train steps, with the input and weight
    gradients that aten's convolution_backward computes (cuDNN) marked as
    ranges."""
    from torch.profiler import record_function
    mods = (conv3x3_mod, conv_chain_mod, conv_s2_mod)
    saved = [(m, getattr(m, 'conv2d_input_grad', None),
              getattr(m, 'conv2d_weight_grad', None)) for m in mods]

    def ranged(fn, label):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call
    for m, ig, wg in saved:
        if ig is not None:
            m.conv2d_input_grad = ranged(ig, 'range:cudnn_dgrad')
        if wg is not None:
            m.conv2d_weight_grad = ranged(wg, 'range:cudnn_wgrad')
    try:
        def run():
            for i in range(n):
                model.optimize_parameters(first_iter + i)
            torch.cuda.synchronize()
        prof = device_profile(run, n, 'train_steps')
    finally:
        for m, ig, wg in saved:
            if ig is not None:
                m.conv2d_input_grad = ig
            if wg is not None:
                m.conv2d_weight_grad = wg
    groups = {}
    for name, ms in prof.pop('by_kernel'):
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    prof['device_ms_per_step_by_group'] = groups
    return prof


def _resume_round_trip(batch, root):
    """train_loop for 6 steps straight, against 4 steps with a save at
    step 4 followed by an auto-resumed run to step 6 (bf16 AMP, EMA on,
    one repeated batch, deterministic cuDNN). Returns the max |diff| of
    the parameters and of the EMA (both must be 0)."""
    def opt_for(tag, total):
        opt = _train_opt(TRAIN_T, amp=True, ema_decay=0.999)
        opt['train']['total_iter'] = total
        opt['logger'].update(print_freq=2, save_checkpoint_freq=4)
        opt['val']['val_freq'] = None       # the train state only
        opt['path'].update(models=os.path.join(root, tag, 'models'),
                           training_states=os.path.join(root, tag, 'states'))
        return opt
    loader = [batch] * 8
    straight = train_loop(opt_for('a', 6), loader, device='cuda')
    train_loop(opt_for('b', 4), loader, device='cuda')
    resumed_opt = opt_for('b', 6)
    resumed_opt['auto_resume'] = True
    resumed = train_loop(resumed_opt, loader, device='cuda')
    if resumed.optimizer.count != 6:
        raise AssertionError(f'resumed optimizer count '
                             f'{resumed.optimizer.count}')
    got = dict(resumed.net.named_parameters())
    d_params = max((got[n] - p).abs().max().item()
                   for n, p in straight.net.named_parameters())
    d_ema = max((a - b).abs().max().item() for a, b in zip(
        _leaves(resumed.ema_params), _leaves(straight.ema_params)))
    return d_params, d_ema


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def phase_train():
    """The train main path. Returns the launches of its checked steps."""
    per_step = {k: PER_TRAIN_STEP.get(k, 0) for k in KERNELS}
    rng = np.random.default_rng(SEED + 5)
    batch = _train_batch(rng, TRAIN_N, TRAIN_T, TRAIN_HW)
    launches = dict.fromkeys(KERNELS, 0)
    for amp in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = DenoisingModel(_train_opt(TRAIN_T, amp=amp), device='cuda')
        model.feed_data(batch)
        with _NoConv2d():
            for i in range(WARMUP):
                reset_counts()
                model.optimize_parameters(i + 1)
                step = counts()
                if step != per_step:
                    raise AssertionError(f'amp={amp}: train step {i + 1} '
                                         f'launched {step}')
                for k, v in step.items():
                    launches[k] += v
            reset_counts()
            ms, losses = _time_steps(model, TIMED_STEPS, WARMUP + 1)
            for k, v in counts().items():
                if v != per_step[k] * TIMED_STEPS:
                    raise AssertionError(f'amp={amp}: {k} launched {v} times '
                                         f'in {TIMED_STEPS} steps')
                launches[k] += v
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            prof = None
            if amp:
                prof = _profile_steps(model, 8, WARMUP + TIMED_STEPS + 1)
                # the profiler slows the host, so its window is longer than
                # an unprofiled step: the device's idle share of the timed
                # steps, from the profiled busy time
                prof['idle_share_of_timed_step'] = \
                    1 - prof['device_busy_ms_per_unit'] / ms
        first, last = np.mean(losses[:10]), np.mean(losses[20:30])
        TRAIN_MS[amp] = ms
        emit({'phase': 'train', 'amp': amp,
              'batch': [TRAIN_N, TRAIN_T, TRAIN_HW, TRAIN_HW],
              'launches_per_step': per_step, 'ms_per_step': ms,
              'it_per_s': 1e3 / ms, 'loss_steps_1_10_mean': first,
              'loss_steps_21_30_mean': last, 'loss_last': losses[-1],
              'peak_allocated_gb': peak_gb, 'profile': prof})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f'amp={amp}: non-finite loss')
        if not last < first:
            raise AssertionError(f'amp={amp}: loss did not fall on the '
                                 f'repeated batch ({first} -> {last})')
        del model
    # the reference's effective batch: 16 clips (8 per GPU on two GPUs)
    batch16 = _train_batch(rng, 2 * TRAIN_N, TRAIN_T, TRAIN_HW)
    for amp in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = DenoisingModel(_train_opt(TRAIN_T, amp=amp), device='cuda')
        model.feed_data(batch16)
        with _NoConv2d():
            _time_steps(model, 2, 1)
            ms, losses = _time_steps(model, 10, 3)
        emit({'phase': 'train_batch16', 'amp': amp,
              'batch': [2 * TRAIN_N, TRAIN_T, TRAIN_HW, TRAIN_HW],
              'ms_per_step': ms, 'it_per_s': 1e3 / ms,
              'peak_allocated_gb': torch.cuda.max_memory_allocated() / 1e9})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f'batch 16, amp={amp}: non-finite loss')
        del model
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as root, _NoConv2d():
            d_params, d_ema = _resume_round_trip(batch, root)
    finally:
        torch.backends.cudnn.deterministic = False
    emit({'phase': 'train_resume', 'steps': [4, 2],
          'max_abs_diff_params': d_params, 'max_abs_diff_ema': d_ema})
    if d_params != 0 or d_ema != 0:
        raise AssertionError(f'resume differs from the uninterrupted run: '
                             f'params {d_params}, EMA {d_ema}')
    return launches


# ---------------------------------------------------------------------------
# phase 9: the chunked main path
# ---------------------------------------------------------------------------

def _chunks(t_len, psz):
    """Chunks the temp_psz protocol runs over t_len frames."""
    return t_len // psz + (t_len % psz > 0)


def _time_block_stream(bsd, x):
    """Best of 3 host-clock ms per frame of BlockStreamDenoiser.push over
    TIMED frames resident on the card, ending in a synchronize."""
    best = float('inf')
    for _ in range(3):
        bsd.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(TIMED):
            bsd.push(x[k % x.shape[0]])
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / TIMED)
    return best * 1e3


def phase_chunked(nets):
    """Returns the launches of the checked main-path runs."""
    clean, noisy = _clips(np.random.default_rng(SEED + 6), 1, CHUNK_T)[0]
    n_chunks = _chunks(CHUNK_T, CHUNK_PSZ)
    launches = dict.fromkeys(KERNELS, 0)
    kw = dict(noise_sigma=SIGMA, temp_psz=CHUNK_PSZ,
              future_buffer_len=CHUNK_FUTURE)
    outs = {}
    for mode, net in nets.items():
        reset_counts()
        with _NoConv2d():
            outs[mode] = denoise_seq(net, None, noisy,
                                     compute_dtype=torch.bfloat16, **kw)
        run = counts()
        for k, v in run.items():
            launches[k] += v
            if v != PER_CHUNK.get(k, 0) * n_chunks:
                raise AssertionError(f'{mode}: {k} launched {v} times in '
                                     f'{n_chunks} chunks, expected '
                                     f'{PER_CHUNK.get(k, 0)} each')
        _check_out(outs[mode], clean)

    # fp32 kernels against the plain fp32 path on the CPU (weights copied
    # there, so no kernel runs), chunked by the same protocol, at a reduced
    # size: look-ahead, sticky disable, tail
    rng = np.random.default_rng(SEED + 7)
    small = rng.uniform(0, 1, (13, 3, 64, 112)).astype(np.float32)
    small_kw = dict(noise_sigma=SIGMA, temp_psz=4, future_buffer_len=2)
    for mode, net in nets.items():
        reset_counts()
        ref = denoise_seq(net.prepared('cpu', torch.float32), net.cfg, small,
                          **small_kw)
        if any(counts().values()):
            raise AssertionError(f'{mode}: the CPU reference launched a '
                                 f'kernel: {counts()}')
        got = denoise_seq(net, None, small, compute_dtype=torch.float32,
                          **small_kw)
        err, scale = rel_err(torch.from_numpy(got), torch.from_numpy(ref))
        emit({'phase': 'chunked_parity_fp32', 'shift_mode': mode,
              'shape': list(small.shape), 'max_abs_err': err,
              'tol': FP32_TOL * scale})
        if not err <= FP32_TOL * scale:
            raise AssertionError(f'{mode}: fp32 chunked kernels vs plain: '
                                 f'{err}')

    # bf16 at full size by phase 4's rule (no more than 1 dB below the
    # whole clip's bf16 PSNR); the causal net's chunked output is the
    # whole-clip function, held to its whole-clip fp32 output
    to_t = torch.from_numpy
    psnrs = {}
    for mode, net in nets.items():
        causal = 'toFutureOnly' in mode
        ref32 = denoise_seq(net, None, noisy, compute_dtype=torch.float32,
                            **(kw if not causal else {'noise_sigma': SIGMA}))
        whole16 = denoise_seq(net, None, noisy, noise_sigma=SIGMA,
                              compute_dtype=torch.bfloat16)
        whole32 = ref32 if causal else denoise_seq(
            net, None, noisy, noise_sigma=SIGMA, compute_dtype=torch.float32)
        psnrs[mode] = {'chunked_bf16_vs_' + ('whole' if causal else 'chunked')
                       + '_fp32': psnr(to_t(outs[mode]), to_t(ref32)),
                       'whole_bf16_vs_whole_fp32': psnr(to_t(whole16),
                                                        to_t(whole32))}
        got, bar = psnrs[mode].values()
        if not got > bar - 1.0:
            raise AssertionError(f'{mode}: chunked bf16 {got} dB, whole-clip '
                                 f'bf16 {bar} dB')
        del ref32, whole16, whole32

    # BlockStreamDenoiser push / flush against denoise_seq, bit for bit
    net = nets['TSM']
    x = _stream_input(noisy)
    want = denoise_seq(net, None, noisy, noise_sigma=SIGMA, temp_psz=BLOCK_F,
                       future_buffer_len=CHUNK_FUTURE,
                       compute_dtype=torch.bfloat16)
    bsd = BlockStreamDenoiser(net, None, psz=BLOCK_F,
                              future_buffer_len=CHUNK_FUTURE,
                              dtype=torch.bfloat16)
    reset_counts()
    with _NoConv2d():
        got = []
        for f in x:
            got += bsd.push(f)
        got += bsd.flush()
    for k, v in counts().items():
        launches[k] += v
    got = torch.stack(got, dim=1)[0].permute(0, 3, 1, 2).float().cpu()
    bsd_equal = bool(torch.equal(got, to_t(want)))
    if not bsd_equal:
        raise AssertionError('BlockStreamDenoiser differs from denoise_seq: '
                             f'{(got - to_t(want)).abs().max().item()}')

    # times: one chunk (device events), the same 13 frames through the
    # zero-boundary MIMO forward (the difference is the 16 one-frame
    # recomputes and the carry copies), an 85-frame clip numpy in and out
    timing = {}
    long_noisy = _clips(np.random.default_rng(SEED + 8), 1, LONG_T)[0][1]
    for mode, net in nets.items():
        p = net.prepared('cuda', torch.bfloat16)
        xc = _stream_input(noisy[:CHUNK_PSZ + CHUNK_FUTURE])[:, 0][None]
        with torch.no_grad():
            _, carries = wnet_apply_chunk(p, xc, net.cfg, None,
                                          future_buffer_len=CHUNK_FUTURE)
            chunk_ms = median_ms(lambda: wnet_apply_chunk(
                p, xc, net.cfg, carries, future_buffer_len=CHUNK_FUTURE))
            mimo_ms = median_ms(lambda: wnet_apply(p, xc, net.cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise_seq(net, None, long_noisy, compute_dtype=torch.bfloat16,
                          **kw)
        wall = time.perf_counter() - t0
        if out.shape != (LONG_T, 3, H, W) or not np.isfinite(out).all():
            raise AssertionError(f'{mode}: 85-frame chunked output')
        timing[mode] = {'chunk_ms_median_of_10': chunk_ms,
                        'ms_per_kept_frame': chunk_ms / CHUNK_PSZ,
                        'mimo_13_frames_ms': mimo_ms,
                        'recompute_share': 1 - mimo_ms / chunk_ms,
                        f'denoise_seq_s_per_{LONG_T}_frame_clip': wall}
        del out
    bsd_ms = _time_block_stream(bsd, x)
    emit({'phase': 'chunked', 'frames': CHUNK_T, 'temp_psz': CHUNK_PSZ,
          'future_buffer_len': CHUNK_FUTURE, 'chunks': n_chunks,
          'launches_per_chunk': PER_CHUNK, 'psnr_db': psnrs,
          'block_stream_equals_denoise_seq': bsd_equal,
          f'block_stream_{BLOCK_F}_{CHUNK_FUTURE}_ms_per_frame': bsd_ms,
          'timing': timing})
    del bsd
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the eval main path
# ---------------------------------------------------------------------------

def _top_blocks(path):
    """The lines of each top-level key's block of a YAML file, verbatim."""
    blocks, key = {}, None
    with open(path) as f:
        for line in f.read().split('\n'):
            m = re.match(r'([A-Za-z_]\w*):', line)
            if m:
                key = m.group(1)
                blocks[key] = []
            if key is not None:
                blocks[key].append(line)
    return blocks


def _test_yml(root, val_dir, ckpt):
    """A test option file: options/test/bsvd_c64.yml's network_g (its
    pretrain_ckpt line dropped), val and logger blocks verbatim, the
    seeded checkpoint as path.pretrain_network_g, and one ValFolderDataset
    on the val PNG folders."""
    blocks = _top_blocks(TEST_YML)
    lines = ['name: bsvd_c64', 'model_type: DenoisingModel', 'num_gpu: 1',
             'manual_seed: 10', '', 'datasets:', '  val_1:',
             '    name: synth_20', '    type: ValFolderDataset',
             f'    valsetdir: {val_dir}',
             f'    num_validation_frames: {EVAL_T}', '    valnoisestd: 20',
             '']
    lines += [ln for ln in blocks['network_g']
              if not ln.strip().startswith('pretrain_ckpt:')]
    lines += ['path:', f'  pretrain_network_g: {ckpt}',
              '  strict_load_g: true', '  resume_state: ~', '']
    lines += blocks['val'] + blocks['logger']
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, 'bsvd_c64_synth.yml')
    with open(path, 'w') as f:
        f.write('\n'.join(lines))
    return path


class _ValSeconds:
    """Keeps each validation's ``val_seconds`` (read, denoise, metrics,
    save) while a pipeline runs."""

    def __enter__(self):
        self.orig, self.runs = DenoisingModel.nondist_validation, []
        spy = self

        def run(model, *a, **k):
            out = spy.orig(model, *a, **k)
            spy.runs.append(dict(model.val_seconds))
            return out
        DenoisingModel.nondist_validation = run
        return self

    def __exit__(self, *exc):
        DenoisingModel.nondist_validation = self.orig


def _routes_since(before):
    return {k: v - before.get(k, 0) for k, v in utils_common.ROUTES.items()
            if v - before.get(k, 0)}


def phase_eval(nets, data, chunked=True):
    """The test CLI (``test_pipeline(root, cmd=['-opt', yml])``) over the
    540p val folder (PNG, or JPEG in phase 12a), whole clip and, with
    ``chunked`` and --force_yml, by the train yml's chunked protocol.
    Returns the main-path launches."""
    net = nets['TSM']
    launches = dict.fromkeys(KERNELS, 0)
    root = os.path.join(WORK, f"eval_{data['route']}")
    os.makedirs(root)
    ckpt = os.path.join(root, 'net_g.npz')
    save_npz_params(ckpt, {'params': to_jax_params(net.param_tree(),
                                                   net.cfg)})
    yml = _test_yml(root, data['val'], ckpt)
    n_clips = len(data['val_clips'])
    protocols = [('whole_clip', [], 1, PER_FORWARD)]
    if chunked:
        protocols.append(('chunked', [f'val:temp_psz={CHUNK_PSZ}',
                                      f'val:future_buffer_len={CHUNK_FUTURE}'],
                          _chunks(EVAL_T, CHUNK_PSZ), PER_CHUNK))
    for label, force, n_fwd, per in protocols:
        run_root = os.path.join(root, label)
        cmd = ['-opt', yml] + (['--force_yml', *force] if force else [])
        opt, _ = parse_options(run_root, is_train=False, cmd=cmd)
        routes = dict(utils_common.ROUTES)
        reset_counts()
        t0 = time.perf_counter()
        with _NoConv2d(), _ValSeconds() as secs:
            res = test_pipeline(run_root, cmd=cmd)['synth_20']
        wall = time.perf_counter() - t0
        run = counts()
        routes = _routes_since(routes)
        for k, v in run.items():
            launches[k] += v
            if v != per.get(k, 0) * n_fwd * n_clips:
                raise AssertionError(f'eval {label}: {k} launched {v} '
                                     f'times for {n_clips} clips')
        if not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f'eval {label}: metrics {res}')
        if routes != {data['route']: EVAL_T * n_clips}:
            raise AssertionError(f'eval {label}: frames read by {routes}')
        log = opt['path']['log']
        csvs = sorted(f for f in os.listdir(log) if f.endswith('.csv'))
        pngs = [f for _, _, fs in os.walk(opt['path']['visualization'])
                for f in fs if f.endswith('.png')]
        if csvs != [f'synth_20_clip{i:02d}.csv' for i in range(n_clips)] or \
                len(pngs) != EVAL_T * n_clips:
            raise AssertionError(f'eval {label}: {csvs}, {len(pngs)} '
                                 f'frames saved')
        # the pipeline's float PSNR of clip00 against denoise_seq's output
        # scored by hand
        with open(os.path.join(log, csvs[0])) as f:
            rows = list(csv.reader(f))[1:]
        piped = float(np.mean([np.float32(r[2]) for r in rows]))
        item = build_dataset(dict(opt['datasets']['val_1'],
                                  manual_seed=opt['manual_seed']))[0]
        if not np.array_equal(np.round(item['gt'][0] * 255),
                              data['val_clips'][0].transpose(0, 3, 1, 2)):
            raise AssertionError('eval: the val frames read back differ')
        lq = torch.from_numpy(item['lq'][0])
        pad = F.pad(lq, (0, 0, 0, (16 - H % 16) % 16), mode='reflect')
        out = denoise_seq(net, None, pad, noise_sigma=20 / 255,
                          compute_dtype=torch.bfloat16,
                          temp_psz=opt['val']['temp_psz'],
                          future_buffer_len=opt['val'][
                              'future_buffer_len'])[..., :H, :W]
        by_hand = float(np.mean([np.float32(calculate_psnr_float(
            o, g, crop_border=2)) for o, g in zip(out, item['gt'][0])]))
        if not abs(piped - by_hand) < 1e-4:
            raise AssertionError(f'eval {label}: psnr_float {piped} in '
                                 f'the pipeline, {by_hand} by hand')
        per_clip = {k: v / n_clips for k, v in secs.runs[0].items()}
        emit({'phase': 'eval', 'reader': data['route'], 'protocol': label,
              'cmd': cmd[2:],
              'clips': n_clips, 'frames': EVAL_T, 'shape': [H, W],
              'padded_to': [H + (16 - H % 16) % 16, W], 'routes': routes,
              'metrics': res,
              'psnr_float_clip00': {'pipeline': piped, 'by_hand': by_hand},
              'launches': run, 'wall_s_per_clip': wall / n_clips,
              's_per_clip': per_clip})
    return launches


# ---------------------------------------------------------------------------
# phase 11: the WNet options
# ---------------------------------------------------------------------------

# options/test/bsvd_raw.yml network_g (its pretrain_ckpt dropped: random
# weights) and options/train/bsvd_c32_blind.yml network_g, full width; the
# c64 net of phase 3 with shift_input (both modes), BN (seeded running
# statistics) and instance norm
OPTION_NETS = {
    'raw': shipped_net(os.path.join(ROOT, 'options', 'test', 'bsvd_raw.yml')),
    'c32_blind': shipped_net(os.path.join(ROOT, 'options', 'train',
                                          'bsvd_c32_blind.yml')),
    'shift_input': dict(C64, shift_input=True),
    'shift_input_causal': dict(C64, shift_input=True,
                               shift_mode='TSM_toFutureOnly'),
    'bn': dict(C64, norm='bn'),
    'in': dict(C64, norm='in'),
}
PUSHED_OPTIONS = ('shift_input', 'shift_input_causal', 'in')
# 13 frames: a chunk of the train yml's protocol (temp_psz 11 + 2)
CHUNK_FRAMES = CHUNK_PSZ + CHUNK_FUTURE
OPTION_STEPS = 5


def option_launches(cfg, unit):
    """Launches per unit of work by the routes of archs/wnet_arch and
    archs/streaming: 'forward' (a whole clip), 'chunk' (a forward and a
    one-frame K1 at each shift site), 'push' / 'block' (a steady push /
    push_block of BLOCK_F), 'train' (a train step: the forward with BN on
    batch statistics, K1 for each K2's intermediate in the backward, K7 for
    every stride-1 conv; with remat the forward twice)."""
    s, si = cfg.stage_num, int(cfg.shift_input)
    split = cfg.norm == 'in' or (unit == 'train' and cfg.norm == 'bn')
    stem = 2 if split and not si else 0
    outc = 2 if split else 0
    k2 = s * ((0 if split or si else 1) + (0 if split else 1))
    c = dict.fromkeys(KERNELS, 0)
    c.update(conv_chain=k2, conv_s2=2 * s, conv_ps=2 * s)
    if unit in ('push', 'block'):
        c['conv3x3'] = s * (stem + outc)
        c['bibuffer_conv' if unit == 'push' else 'bibuffer_multi'] = \
            s * (8 + 2 * si)
        return c
    c['conv3x3'] = s * (8 + 2 * si + stem + outc)
    c['shift_conv_fused_v1'] = s * (7 + 2 * si)
    if unit == 'chunk':
        c['conv3x3'] += cfg.shift_num
    if unit == 'train':
        fwd = 2 if cfg.remat else 1
        for k in ('conv3x3', 'conv_chain', 'conv_s2', 'conv_ps',
                  'shift_conv_fused_v1'):
            c[k] *= fwd
        c['conv3x3'] += k2
        c['conv3x3_dw'] = 14 * s
    return c


def _seed_bn(net, seed):
    """Seeded running statistics and affine parameters in every BN leaf of
    the module (in place), as a trained net would carry."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(net.named_parameters()) + list(
                net.named_buffers()):
            leaf = name.rsplit('.', 1)[-1]
            lo, hi = {'scale': (0.5, 1.5), 'bias': (-0.2, 0.2),
                      'mean': (-0.3, 0.3), 'var': (0.5, 2.0)}.get(
                leaf, (None, None))
            if lo is not None:
                t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)


def _option_input(cfg, noisy):
    """(T, 3, H, W) numpy -> (1, T, H, W, C_in) bf16 on the card: RGB, a
    fourth raw channel (the green twice) where the net takes 4 colour
    channels, and the noise map unless blind."""
    x = torch.from_numpy(noisy).cuda().to(torch.bfloat16)
    colour = cfg.in_ch - 1 if not cfg.blind else 3
    if colour == 4:
        x = torch.cat([x, x[:, 1:2]], dim=1)
    if not cfg.blind:
        x = torch.cat([x, torch.full_like(x[:, :1], SIGMA)], dim=1)
    return x.permute(0, 2, 3, 1)[None].contiguous()


def _check_launches(name, got, want):
    if got != want:
        raise AssertionError(f'{name}: launched {got}, expected {want}')


def _option_parity(name, net, rng):
    """fp32 card output (whole clip, and for the pushed options the stream
    and a chunk) against the plain fp32 path on the CPU with the CPU
    weights (no kernel launched there), at 4 frames of 64x112 (the stream:
    the latency + 2); bf16 card whole clip by phase 4's PSNR rule."""
    cfg = net.cfg
    x = torch.from_numpy(rng.uniform(0, 1, (1, 4, 64, 112, cfg.effective_in_ch))
                         .astype(np.float32))
    cpu32, cpu16 = net.prepared('cpu', torch.float32), net.prepared(
        'cpu', torch.bfloat16)
    lat = streaming.pipeline_latency(cfg)
    xs = torch.from_numpy(rng.uniform(
        0, 1, (1, lat + 2, 64, 112, cfg.effective_in_ch)).astype(np.float32))
    streamed = name in PUSHED_OPTIONS

    def run(p, dev, dtype=torch.float32):
        with torch.no_grad():
            r = {'clip': wnet_apply(p, x.to(dev, dtype), cfg).cpu()}
            if streamed and dtype == torch.float32:
                r['stream'] = streaming_apply(p, xs.to(dev), cfg).cpu()
                r['chunk'] = wnet_apply_chunk(p, xs[:, :2].to(dev), cfg,
                                              None, 1)[0].cpu()
        return r
    reset_counts()
    ref, plain16 = run(cpu32, 'cpu'), run(cpu16, 'cpu', torch.bfloat16)
    if any(counts().values()):
        raise AssertionError(f'{name}: the CPU reference launched a kernel: '
                             f'{counts()}')
    got32 = run(net.prepared('cuda', torch.float32), 'cuda')
    got16 = run(net.prepared('cuda', torch.bfloat16), 'cuda',
                torch.bfloat16)['clip']
    out = {k: rel_err(got32[k], ref[k]) for k in ref}
    ref, plain16 = ref['clip'], plain16['clip']
    for part, (err, scale) in out.items():
        if not err <= FP32_TOL * scale:
            raise AssertionError(f'{name}: fp32 {part} on the card vs the '
                                 f'plain path: {err} > {FP32_TOL * scale}')
    p16, plain_p16 = psnr(got16, ref), psnr(plain16, ref)
    if not p16 > plain_p16 - 1.0:
        raise AssertionError(f'{name}: bf16 kernel path {p16} dB vs fp32, '
                             f'plain bf16 {plain_p16} dB')
    return {'fp32_max_abs_err': {k: v[0] for k, v in out.items()},
            'fp32_tol': {k: FP32_TOL * v[1] for k, v in out.items()},
            'bf16_psnr_db_vs_fp32': p16, 'plain_bf16_psnr_db_vs_fp32':
            plain_p16}


def _option_push(name, net, noisy):
    """Push the clip, flush, check each steady push's and a steady
    push_block's launches; steady ms per frame (push, best of 3)."""
    cfg = net.cfg
    x = _option_input(cfg, noisy)[0][:, None]     # (T, 1, H, W, C)
    sd = StreamDenoiser(net, None, batch=1, height=H, width=W,
                        dtype=torch.bfloat16)
    lat = sd.latency
    launches = dict.fromkeys(KERNELS, 0)
    outs = []
    with _NoConv2d():
        reset_counts()
        for i in range(STREAM_T):
            before = counts()
            out = sd.push(x[i])
            if i >= lat:
                _check_launches(f'{name} steady push {i}',
                                delta_since(before),
                                option_launches(cfg, 'push'))
            if out is not None:
                outs.append(out)
        outs += sd.flush()
        for k, v in counts().items():
            launches[k] += v
        if len(outs) != STREAM_T or not all(torch.isfinite(o).all()
                                            for o in outs):
            raise AssertionError(f'{name}: {len(outs)} stream outputs for '
                                 f'{STREAM_T} frames, or not finite')
        sd.reset()
        for i in range(lat):
            sd.push(x[i])
        reset_counts()
        sd.push_block(x[lat:lat + BLOCK_F])
        block = counts()
        _check_launches(f'{name} push_block', block,
                        option_launches(cfg, 'block'))
        for k, v in block.items():
            launches[k] += v
    sd.reset()
    for i in range(lat + 4):
        sd.push(x[i % STREAM_T])
    rec = {'latency': lat, 'push_ms_per_frame': _time_per_frame(sd, x, False)}
    if cfg.norm == 'in':
        # where a split push's time goes: the norm passes are torch ops
        rec['push_profile'] = _profile_pushes(sd, x, n=8)
    return launches, rec


def _option_train(name, opt, amp, batch):
    """A few train steps of the c64 TSN with ``opt``'s net2d options:
    launches per step, ms per step (host clock, synchronised) and peak
    memory."""
    model = DenoisingModel(opt, device='cuda')
    cfg = model.cfg
    if cfg.norm == 'bn':
        _seed_bn(model.net, SEED + 11)
    model.feed_data(batch)
    launches = dict.fromkeys(KERNELS, 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats = [t.clone() for n, t in model.net.named_buffers()]
    with _NoConv2d():
        for i in range(2):
            reset_counts()
            model.optimize_parameters(i + 1)
            _check_launches(f'{name} train step', counts(),
                            option_launches(cfg, 'train'))
            for k, v in counts().items():
                launches[k] += v
        reset_counts()
        ms, losses = _time_steps(model, OPTION_STEPS, 3)
        for k, v in counts().items():
            launches[k] += v
    if not all(np.isfinite(losses)):
        raise AssertionError(f'{name}: non-finite train loss {losses}')
    moved = [not torch.equal(a, b) for a, b in
             zip(stats, [t for _, t in model.net.named_buffers()])]
    if cfg.norm == 'bn' and not all(moved):
        raise AssertionError(f'{name}: BN running statistics did not move')
    return launches, {'amp_requested': amp, 'amp': model.amp,
                      'launches_per_step': {k: v for k, v in option_launches(
                          cfg, 'train').items() if v},
                      'ms_per_step': ms,
                      'peak_allocated_gb':
                      torch.cuda.max_memory_allocated() / 1e9,
                      'loss_first_last': [losses[0], losses[-1]]}


def phase_options(nets, clip):
    """The WNet options on every path. Returns the launches of the checked
    main-path runs."""
    clean, noisy = clip
    launches = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(SEED + 12)

    def add(run):
        for k, v in run.items():
            launches[k] += v

    # the c64 norm 'none' forward of phase 3, timed beside the options
    x64 = _option_input(nets['TSM'].cfg, noisy[:T])
    p64 = nets['TSM'].prepared(x64.device, torch.bfloat16)
    with torch.no_grad():
        base_ms = median_ms(lambda: wnet_apply(p64, x64, nets['TSM'].cfg),
                            reps=5)
    emit({'phase': 'options_baseline', 'config': 'c64 norm none (phase 3)',
          'forward_ms_median_of_5': base_ms, 'frames': T})
    for name, opt in OPTION_NETS.items():
        net = build_network(opt)
        cfg = net.cfg
        if cfg.norm == 'bn':
            _seed_bn(net, SEED + 10)
        x = _option_input(cfg, noisy[:T])
        p = net.prepared(x.device, torch.bfloat16)
        with _NoConv2d(), torch.no_grad():
            reset_counts()
            y = wnet_apply(p, x, cfg)
            fwd = counts()
            _check_launches(f'{name} forward', fwd,
                            option_launches(cfg, 'forward'))
            add(fwd)
        if y.shape != x.shape[:-1] + (cfg.out_ch,) or not torch.isfinite(
                y).all():
            raise AssertionError(f'{name}: forward output {tuple(y.shape)} '
                                 f'or not finite')
        with torch.no_grad():
            ms = median_ms(lambda: wnet_apply(p, x, cfg), reps=5)
            prof = None if cfg.norm != 'in' else device_profile(
                lambda: (wnet_apply(p, x, cfg), torch.cuda.synchronize()),
                1, 'in_forward')
        rec = {'phase': 'options', 'config': name, 'shift_num':
               cfg.shift_num, 'launches_per_forward':
               {k: v for k, v in fwd.items() if v},
               'forward_ms_median_of_5': ms, 'frames': T,
               'forward_vs_c64_none': ms / base_ms}
        if prof is not None:
            rec['forward_profile'] = {
                k: prof[k] for k in ('device_busy_ms_per_unit', 'idle_share',
                                     'top_device_ms_per_unit')}
        rec.update(_option_parity(name, net, rng))
        if name in PUSHED_OPTIONS:
            run, push = _option_push(name, net, noisy)
            add(run)
            rec.update(push)
        if name == 'shift_input':
            xc = _option_input(cfg, noisy[:CHUNK_FRAMES])
            with _NoConv2d(), torch.no_grad():
                reset_counts()
                _, carries = wnet_apply_chunk(p, xc, cfg, None,
                                              CHUNK_FUTURE)
                chunk = counts()
                _check_launches(f'{name} chunk', chunk,
                                option_launches(cfg, 'chunk'))
                add(chunk)
                chunk_ms = median_ms(lambda: wnet_apply_chunk(
                    p, xc, cfg, carries, CHUNK_FUTURE), reps=5)
            rec.update(chunk_ms_median_of_5=chunk_ms,
                       chunk_frames=CHUNK_FRAMES,
                       carries=len(carries))
        emit(rec)
        del net, p, x, y

    # train steps at the train yml's batch (8 x 11 x 96x96): BN in fp32
    # (train.fp16 asked for and ignored), shift_input and c64 with and
    # without remat in bf16 AMP
    batch = _train_batch(np.random.default_rng(SEED + 13), TRAIN_N, TRAIN_T,
                         TRAIN_HW)
    for name, over, amp in (('bn', {'norm': 'bn'}, True),
                            ('shift_input', {'shift_input': True}, True),
                            ('c64', {}, True),
                            ('c64_remat', {'remat': True}, True)):
        opt = _train_opt(TRAIN_T, amp=amp)
        opt['network_g']['net2d_opt'].update(over)
        run, rec = _option_train(name, opt, amp, batch)
        add(run)
        emit(dict({'phase': 'options_train', 'config': name,
                   'batch': [TRAIN_N, TRAIN_T, TRAIN_HW, TRAIN_HW]}, **rec))
    return launches


# ---------------------------------------------------------------------------
# phase 12: the entry points on PNG frame folders
# ---------------------------------------------------------------------------

# train: DAVIS 480p frame size; val: Set8's 540x960 (phase 10's clips)
TRAIN_CLIPS, TRAIN_FRAMES, TRAIN_FRAME_HW = 4, 24, (480, 854)
VAL_CLIPS = 1
CLI_ITERS, CLI_RESUME_ITERS = 20, 22


def _write_clip(folder, frames, pool):
    """uint8 (T, H, W, 3) RGB frames as PNG files (zlib level 6): the odd
    frames with PNG filter r % 5 on row r (every filter type, as libpng's
    adaptive choice mixes them), the even ones with filter 0 (the port's
    imwrite)."""
    os.makedirs(folder)

    def write(k):
        f = frames[k]
        filters = np.arange(f.shape[0]) % 5 if k % 2 else None
        with open(os.path.join(folder, f'{k:05d}.png'), 'wb') as fh:
            fh.write(encode_png(f[..., ::-1], filters=filters))
    list(pool.map(write, range(len(frames))))


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_frames():
    """Synthetic PNG frame folders written with the port's encoder, read
    back exactly by the zlib reader, and its ms per frame."""
    root = os.path.join(WORK, 'datasets')
    rng = np.random.default_rng(SEED + 14)
    train = synthetic_clips(rng, TRAIN_CLIPS, TRAIN_FRAMES,
                            *TRAIN_FRAME_HW).transpose(0, 1, 3, 4, 2)
    val = np.stack([np.round(c * 255).astype(np.uint8).transpose(0, 2, 3, 1)
                    for c, _ in _clips(np.random.default_rng(SEED + 9),
                                       VAL_CLIPS, EVAL_T)])
    data = {'train': os.path.join(root, 'train'),
            'val': os.path.join(root, 'val'), 'val_clips': val,
            'train_clips': train, 'route': 'png_decode'}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for split, clips in (('train', train), ('val', val)):
            for i, c in enumerate(clips):
                _write_clip(os.path.join(data[split], f'clip{i:02d}'), c,
                            pool)
    write_s = time.perf_counter() - t0
    rec = {'phase': 'frames', 'write_s': write_s, 'cpu_count': os.cpu_count()}
    for split, clips in (('train', train), ('val', val)):
        folder = os.path.join(data[split], 'clip00')
        files = utils_common.get_imagenames(folder)
        routes = dict(utils_common.ROUTES)
        for i, c in enumerate(clips):
            got = utils_common.load_seq(utils_common.get_imagenames(
                os.path.join(data[split], f'clip{i:02d}')))
            if not np.array_equal(got, c):
                raise AssertionError(f'{split} clip{i:02d}: PNG frames read '
                                     f'back differ')
        raw = clips[0, 0].nbytes
        rec[split] = {
            'clips': len(clips), 'frames': clips.shape[1],
            'hw': list(clips.shape[2:4]),
            'routes': _routes_since(routes),
            'compression_ratio': float(np.mean(
                [os.path.getsize(f) for f in files]) / raw),
            'ms_per_frame_filter0': _median_ms(
                lambda: png_decode.load(files[0]), 10),
            'ms_per_frame_filters0to4': _median_ms(
                lambda: png_decode.load(files[1]), 10)}
    # 11-frame 96x96 windows at random positions, as the loader crops them
    files = utils_common.get_imagenames(os.path.join(data['train'],
                                                     'clip00'))
    h, w = TRAIN_FRAME_HW
    times = []
    for _ in range(10):
        s0 = int(rng.integers(0, TRAIN_FRAMES - TRAIN_T + 1))
        y0 = int(rng.integers(0, h - TRAIN_HW + 1))
        x0 = int(rng.integers(0, w - TRAIN_HW + 1))
        t0 = time.perf_counter()
        win = utils_common.load_crop_seq(files[s0:s0 + TRAIN_T], y0, x0,
                                         TRAIN_HW, TRAIN_HW)
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(win, train[0, s0:s0 + TRAIN_T, y0:y0 + TRAIN_HW,
                                         x0:x0 + TRAIN_HW]):
            raise AssertionError('a 96x96 window differs from the frames')
    rec['window'] = {'frames': TRAIN_T, 'hw': [TRAIN_HW, TRAIN_HW],
                     'ms_median_of_10': statistics.median(times),
                     'ms_min_max': [min(times), max(times)]}
    emit(rec)
    return data


def _train_cli_cmd(data, *extra, iters=CLI_ITERS):
    """The train command on the shipped yml: --force_yml points the
    datasets at the PNG folders and cuts the run to ``iters``; val_freq
    past CLI_ITERS, so the loop validates once, after its last
    iteration."""
    return ['-opt', TRAIN_YML, *extra, '--force_yml',
            f"datasets:train:trainset_dir={data['train']}",
            f"datasets:val:valsetdir={data['val']}",
            f'datasets:val:num_validation_frames={EVAL_T}',
            f'train:total_iter={iters}', 'logger:print_freq=10',
            f'logger:save_checkpoint_freq={CLI_ITERS}',
            f'val:val_freq={CLI_ITERS + 1}']


class _StepClock:
    """While a train pipeline runs: host-clock marks of each train
    iteration (its batch handed to ``feed_data``, ``optimize_parameters``
    returned; validation's feeds make no mark) and the timer averages of
    the MessageLogger lines, by iteration."""

    LINE = re.compile(r'iter: *([0-9,]+), .*time \(data\): ([0-9.]+) '
                      r'\(([0-9.]+)\)')

    def __init__(self, classes=None):
        # the model classes whose feed_data / optimize_parameters are
        # clocked (each its own: a subclass may override either)
        self.classes = classes or (DenoisingModel,)

    def __enter__(self):
        self.marks, self.logged, self.fed = [], {}, None
        self.orig = [(c, c.__dict__.get('feed_data'),
                      c.__dict__.get('optimize_parameters'))
                     for c in self.classes]
        clock = self

        def wrap_feed(fn):
            def feed(model, data):
                clock.fed = time.perf_counter()
                return fn(model, data)
            return feed

        def wrap_step(fn):
            def step(model, *a, **k):
                out = fn(model, *a, **k)
                clock.marks.append((clock.fed, time.perf_counter()))
                return out
            return step

        class Lines(logging.Handler):
            def emit(self, record):
                m = clock.LINE.search(record.getMessage())
                if m:
                    clock.logged[int(m.group(1).replace(',', ''))] = (
                        float(m.group(2)) * 1e3, float(m.group(3)) * 1e3)
        for c, feed, step in self.orig:
            if feed is not None:
                c.feed_data = wrap_feed(feed)
            if step is not None:
                c.optimize_parameters = wrap_step(step)
        self.handler = Lines()
        get_root_logger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for c, feed, step in self.orig:
            if feed is not None:
                c.feed_data = feed
            if step is not None:
                c.optimize_parameters = step
        get_root_logger().removeHandler(self.handler)

    def steady(self, first, last):
        """Iterations first..last (1-based): ms an iteration (from the end
        of step first-1 to the end of step last), the mean wait for each
        batch (end of the step before it to ``feed_data``: the loader, and
        the loop's MessageLogger line every print_freq) and the mean host
        time of feed_data + optimize_parameters."""
        m = self.marks
        n = last - first + 1
        return {'iters': [first, last],
                'ms_per_iter': (m[last - 1][1] - m[first - 2][1]) / n * 1e3,
                'data_wait_ms': statistics.fmean(
                    m[i][0] - m[i - 1][1] for i in range(first - 1, last))
                * 1e3,
                'feed_and_step_ms': statistics.fmean(
                    m[i][1] - m[i][0] for i in range(first - 1, last)) * 1e3}

    def timers(self, a, b):
        """The logged timer averages over iterations 1..b, and over a+1..b
        from the lines at a and b (ms; the lines round to 1 ms)."""
        (ta, da), (tb, db) = self.logged[a], self.logged[b]
        return {f'iter_ms_1_{b}': tb, f'data_ms_1_{b}': db,
                f'iter_ms_{a + 1}_{b}': (b * tb - a * ta) / (b - a),
                f'data_ms_{a + 1}_{b}': (b * db - a * da) / (b - a)}


def _profile_loader_fed(model, data, first_iter, n=5):
    """The device profile of n iterations fed by train_video_loader (the
    train yml's loader options), as the train loop runs them, after 3
    unprofiled ones; the profiler's host overhead is in the window."""
    opt, _ = parse_options(WORK, is_train=True, cmd=_train_cli_cmd(data))
    loader = build_dataset(dict(opt['datasets']['train'],
                                manual_seed=opt['manual_seed']))
    it = iter(loader)

    def iterations(start, count):
        for i in range(count):
            model.feed_data(next(it))
            model.optimize_parameters(start + i)
    try:
        iterations(first_iter, 3)

        def run():
            iterations(first_iter + 3, n)
            torch.cuda.synchronize()
        prof = device_profile(run, n, 'loader_fed_iterations')
    finally:
        loader.close()
    return {'iterations': n,
            'window_ms_per_iter': prof['window_ms_per_unit'],
            'device_busy_ms_per_iter': prof['device_busy_ms_per_unit'],
            'idle_share': prof['idle_share'],
            'top_device_ms_per_iter': prof['top_device_ms_per_unit'][:5]}


def _loader_rate(data, workers, batches):
    """Batches a second of train_video_loader with the train yml's loader
    options (after its first batch unless ``batches`` is 0: then the first
    batch, start-up included)."""
    opt, _ = parse_options(WORK, is_train=True, cmd=_train_cli_cmd(data))
    dopt = dict(opt['datasets']['train'], manual_seed=opt['manual_seed'])
    if workers is not None:
        dopt['num_workers'] = workers
    loader = build_dataset(dopt)
    try:
        it = iter(loader)
        t0 = time.perf_counter()
        batch = next(it)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(batches):
            batch = next(it)
        steady = time.perf_counter() - t0
    finally:
        loader.close()
    n = int(dopt['batch_size_per_gpu'])
    shape = [n, TRAIN_T, 3, TRAIN_HW, TRAIN_HW]
    if list(batch['gt'].shape) != shape or \
            list(batch['noise_map'].shape) != shape[:2] + [1] + shape[3:] or \
            not np.isfinite(batch['lq']).all():
        raise AssertionError(f'loader batch {batch["gt"].shape}')
    secs = steady / batches if batches else first
    return {'workers': loader._num_workers, 'batch': shape,
            'batches_per_s': 1 / secs, 'windows_per_s': n / secs,
            'first_batch_s': first}


def phase_entry(data):
    """The train loader alone, then the train CLI on the shipped yml (fp32,
    bf16 AMP, an auto-resume). Returns the main-path launches."""
    rates = [_loader_rate(data, None, 3), _loader_rate(data, 1, 0)]
    emit({'phase': 'loader', 'cpu_count': os.cpu_count(), 'rates': rates})
    launches = dict.fromkeys(KERNELS, 0)
    root = os.path.join(WORK, 'entry')
    exp = os.path.join(root, 'experiments', 'bsvd_c64_unblind')
    batch = _train_batch(np.random.default_rng(SEED + 15), TRAIN_N, TRAIN_T,
                         TRAIN_HW)
    for label, extra, force, iters in (
            ('fp32', [], [], CLI_ITERS),
            ('bf16', [], ['train:fp16=true', *TB_VAL_METRICS], CLI_ITERS),
            ('bf16_auto_resume', ['--auto_resume'],
             ['train:fp16=true', 'val:val_freq=~'], CLI_RESUME_ITERS)):
        cmd = _train_cli_cmd(data, *extra, iters=iters) + force
        routes = dict(utils_common.ROUTES)
        reset_counts()
        t0 = time.perf_counter()
        with _NoConv2d(), _ValSeconds() as secs, _StepClock() as clock:
            model = train_pipeline(root, cmd=cmd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = counts()
        steps = iters - (CLI_ITERS if extra else 0)
        for k in ('conv3x3', 'conv_chain', 'conv_s2', 'conv_ps'):
            if not run[k] > 0:
                raise AssertionError(f'train CLI {label}: {k} never launched')
        if run['conv3x3_dw'] != PER_TRAIN_STEP['conv3x3_dw'] * steps or \
                model.optimizer.count != iters:
            raise AssertionError(f'train CLI {label}: K7 {run["conv3x3_dw"]} '
                                 f'launches, optimizer count '
                                 f'{model.optimizer.count}: not {steps} '
                                 f'steps to {iters}')
        for k, v in run.items():
            launches[k] += v
        saved = [os.path.join(exp, p) for p in (
            f'models/net_g_{CLI_ITERS}.npz', 'models/net_g_latest.npz',
            f'training_states/{CLI_ITERS}.state', 'bsvd_c64_unblind.yml')]
        missing = [p for p in saved if not os.path.isfile(p)]
        if missing:
            raise AssertionError(f'train CLI {label}: missing {missing}')
        if label == 'bf16':
            # its TensorBoard files and text log, read back in phase 14
            tb_dir = os.path.join(exp, 'tb_logger')
            ENTRY['bf16_tb'] = {
                'files': sorted(os.path.join(tb_dir, f)
                                for f in os.listdir(tb_dir)
                                if f.startswith('events.out.tfevents.')),
                'log': max((os.path.join(exp, f) for f in os.listdir(exp)
                            if f.startswith('train_') and f.endswith('.log')),
                           key=os.path.getmtime),
                'val_dirs': sorted(os.listdir(data['val']))}
        if len(clock.marks) != steps:
            raise AssertionError(f'train CLI {label}: {len(clock.marks)} '
                                 f'iterations clocked, not {steps}')
        val_s = sum(sum(r.values()) for r in secs.runs)
        rec = {'phase': 'train_cli', 'run': label, 'cmd_extra': extra + force,
               'amp': model.amp, 'iters': steps, 'wall_s': wall,
               'validations': len(secs.runs), 'validation_s': val_s,
               'routes': _routes_since(routes), 'launches': run,
               'loss_last': model.get_current_log()['l_pix']}
        if not math.isfinite(rec['loss_last']):
            raise AssertionError(f'train CLI {label}: non-finite loss')
        if not extra:
            # steady state: iterations 11-30, past the start-up of the
            # loader and of the first steps
            rec['steady'] = clock.steady(11, CLI_ITERS)
            # the window of phase 12a's JPEG run, for a like comparison
            rec['steady_3_10'] = clock.steady(3, JPEG_CLI_ITERS)
            ENTRY[f'{label}_steady_3_10'] = rec['steady_3_10']
            ENTRY[f'{label}_steady'] = rec['steady']
            rec['timers_logged'] = clock.timers(10, CLI_ITERS)
            # the same model's step on one in-memory batch, fed to the
            # card before each step as the loop feeds it (phase 8 times
            # the step on a batch fed once)
            with _NoConv2d():
                _time_steps(model, 2, iters + 1, batch)
                rec['in_memory_fed_ms_per_step'], _ = _time_steps(
                    model, 10, iters + 3, batch)
                if model.amp:
                    rec['loader_fed_profile'] = _profile_loader_fed(
                        model, data, iters + 13)
        emit(rec)
        del model
    return launches


# ---------------------------------------------------------------------------
# phase 12a: JPEG frames, and the entry points on JPEG folders
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join(ROOT, 'tests', 'fixtures', 'jpeg')
JPEG_QUALITY, JPEG_SAMPLING = 95, '4:2:0'
# the JPEG train CLI: iterations, and frames a clip of its one validation
JPEG_CLI_ITERS, JPEG_VAL_T = 10, 10


def _write_jpeg_clip(folder, frames, pool):
    """uint8 (T, H, W, 3) RGB frames as JPEG files (quality 95, 4:2:0:
    cv2's defaults), written by the port's writer."""
    os.makedirs(folder)

    def write(k):
        with open(os.path.join(folder, f'{k:05d}.jpg'), 'wb') as fh:
            fh.write(jpeg_encode.encode_jpeg(frames[k], JPEG_QUALITY,
                                             JPEG_SAMPLING))
    list(pool.map(write, range(len(frames))))


def phase_jpeg_frames(data):
    """The JPEG decoder against the committed fixtures, then phase 12's
    clips as JPEG folders: written, read back, timed beside PNG. Returns
    the JPEG folders (their val clips as decoded)."""
    ref = np.load(os.path.join(JPEG_FIXTURES, 'decoded.npz'))
    fixtures = {}
    for name in ref.files:
        got = jpeg_decode.load(os.path.join(JPEG_FIXTURES, f'{name}.jpg'))
        if got.shape != ref[name].shape or not np.array_equal(got,
                                                               ref[name]):
            raise AssertionError(f'JPEG fixture {name}: the decode differs '
                                 f'from libjpeg-turbo\'s')
        fixtures[name] = list(got.shape[:2])
    if len(fixtures) != 8:
        raise AssertionError(f'JPEG fixtures: {sorted(fixtures)}')
    root = os.path.join(WORK, 'datasets_jpg')
    jdata = {'train': os.path.join(root, 'train'),
             'val': os.path.join(root, 'val'), 'route': 'jpeg_decode'}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for split in ('train', 'val'):
            for i, c in enumerate(data[f'{split}_clips']):
                _write_jpeg_clip(os.path.join(jdata[split], f'clip{i:02d}'),
                                 c, pool)
    rec = {'phase': 'frames_jpeg', 'fixtures_bit_exact': fixtures,
           'quality': JPEG_QUALITY, 'sampling': JPEG_SAMPLING,
           'write_s': time.perf_counter() - t0}
    for split in ('train', 'val'):
        clips = data[f'{split}_clips']
        routes = dict(utils_common.ROUTES)
        decoded = []
        for i, c in enumerate(clips):
            got = utils_common.load_seq(utils_common.get_imagenames(
                os.path.join(jdata[split], f'clip{i:02d}')))
            err = got.astype(np.float64) - c
            decoded.append(got)
            # 4:2:0 halves the chroma of the clips' +-20 texture: ~28 dB
            p = 10 * math.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12))
            if not p > 25:
                raise AssertionError(f'{split} clip{i:02d}: JPEG frames read '
                                     f'back at {p:.2f} dB')
        if split == 'val':
            jdata['val_clips'] = np.stack(decoded)
        jfiles = utils_common.get_imagenames(os.path.join(jdata[split],
                                                          'clip00'))
        pfiles = utils_common.get_imagenames(os.path.join(data[split],
                                                          'clip00'))
        raw = clips[0, 0].nbytes
        rec[split] = {
            'clips': len(clips), 'frames': clips.shape[1],
            'hw': list(clips.shape[2:4]), 'routes': _routes_since(routes),
            'psnr_db_clip00': 10 * math.log10(255.0 ** 2 / float(np.mean(
                (decoded[0].astype(np.float64) - clips[0]) ** 2))),
            'bytes_per_frame': float(np.mean([os.path.getsize(f)
                                              for f in jfiles])),
            'compression_ratio': float(np.mean(
                [os.path.getsize(f) for f in jfiles]) / raw),
            'ms_per_frame': _median_ms(lambda: jpeg_decode.load(jfiles[0]),
                                       10),
            'png_ms_per_frame': _median_ms(
                lambda: png_decode.load(pfiles[0]), 10),
            'encode_ms_per_frame': _median_ms(
                lambda: jpeg_encode.encode_jpeg(clips[0, 0], JPEG_QUALITY,
                                                JPEG_SAMPLING), 5)}
    # 11-frame 96x96 windows at random positions, as the loader crops them:
    # each equal to the crop of the whole decode
    rng = np.random.default_rng(SEED + 16)
    h, w = TRAIN_FRAME_HW
    jfiles = utils_common.get_imagenames(os.path.join(jdata['train'],
                                                      'clip00'))
    pfiles = utils_common.get_imagenames(os.path.join(data['train'],
                                                      'clip00'))
    whole = utils_common.load_seq(jfiles)
    times, png_times = [], []
    for _ in range(10):
        s0 = int(rng.integers(0, TRAIN_FRAMES - TRAIN_T + 1))
        y0 = int(rng.integers(0, h - TRAIN_HW + 1))
        x0 = int(rng.integers(0, w - TRAIN_HW + 1))
        t0 = time.perf_counter()
        win = utils_common.load_crop_seq(jfiles[s0:s0 + TRAIN_T], y0, x0,
                                         TRAIN_HW, TRAIN_HW)
        t1 = time.perf_counter()
        utils_common.load_crop_seq(pfiles[s0:s0 + TRAIN_T], y0, x0,
                                   TRAIN_HW, TRAIN_HW)
        png_times.append((time.perf_counter() - t1) * 1e3)
        times.append((t1 - t0) * 1e3)
        if not np.array_equal(win, whole[s0:s0 + TRAIN_T, y0:y0 + TRAIN_HW,
                                         x0:x0 + TRAIN_HW]):
            raise AssertionError('a JPEG 96x96 window differs from the '
                                 'crop of the whole decode')
    rec['window'] = {'frames': TRAIN_T, 'hw': [TRAIN_HW, TRAIN_HW],
                     'ms_median_of_10': statistics.median(times),
                     'ms_min_max': [min(times), max(times)],
                     'png_ms_median_of_10': statistics.median(png_times)}
    rec['loader'] = {'jpeg': [_loader_rate(jdata, None, 3),
                              _loader_rate(jdata, 1, 0)],
                     'png': [_loader_rate(data, None, 3)]}
    emit(rec)
    return jdata


def phase_train_cli_jpeg(jdata):
    """The train CLI on the JPEG folders: bf16 AMP, JPEG_CLI_ITERS
    iterations, validation once at the end. Returns the launches."""
    root = os.path.join(WORK, 'entry_jpg')
    cmd = _train_cli_cmd(jdata, iters=JPEG_CLI_ITERS) + [
        'train:fp16=true',
        f'datasets:val:num_validation_frames={JPEG_VAL_T}']
    routes = dict(utils_common.ROUTES)
    reset_counts()
    t0 = time.perf_counter()
    with _NoConv2d(), _ValSeconds() as secs, _StepClock() as clock:
        model = train_pipeline(root, cmd=cmd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = counts()
    routes = _routes_since(routes)
    for k in ('conv3x3', 'conv_chain', 'conv_s2', 'conv_ps'):
        if not run[k] > 0:
            raise AssertionError(f'train CLI on JPEG: {k} never launched')
    if run['conv3x3_dw'] != PER_TRAIN_STEP['conv3x3_dw'] * JPEG_CLI_ITERS \
            or model.optimizer.count != JPEG_CLI_ITERS:
        raise AssertionError(f'train CLI on JPEG: K7 {run["conv3x3_dw"]} '
                             f'launches, optimizer count '
                             f'{model.optimizer.count}')
    if not routes.get('jpeg_decode', 0) > 0 or set(routes) != {
            'jpeg_decode'}:
        raise AssertionError(f'train CLI on JPEG: frames read by {routes}')
    if len(secs.runs) != 1 or len(clock.marks) != JPEG_CLI_ITERS:
        raise AssertionError(f'train CLI on JPEG: {len(secs.runs)} '
                             f'validations, {len(clock.marks)} iterations')
    rec = {'phase': 'train_cli', 'run': 'bf16_jpeg', 'amp': model.amp,
           'iters': JPEG_CLI_ITERS, 'wall_s': wall, 'routes': routes,
           'launches': run, 'validations': len(secs.runs),
           'validation_s': sum(secs.runs[0].values()),
           'validation_frames_per_clip': JPEG_VAL_T,
           'loss_last': model.get_current_log()['l_pix'],
           'steady': clock.steady(3, JPEG_CLI_ITERS),
           'timers_logged_1_10': clock.logged.get(JPEG_CLI_ITERS)}
    if not math.isfinite(rec['loss_last']):
        raise AssertionError('train CLI on JPEG: non-finite loss')
    ENTRY['jpeg_steady_3_10'] = rec['steady']
    emit(rec)
    return run


# ---------------------------------------------------------------------------
# phase 13: parallel (N streams, two gloo ranks on the card, NCCL CLI)
# ---------------------------------------------------------------------------

N_STREAMS = (1, 2, 4, 8)
# the NCCL train CLI's iterations (bf16 AMP) and its steady window
NCCL_CLI_ITERS = 10
TRAIN_LAYOUTS = ('2x1', '1x2', 'bn:2x1', 'bn:1x2', 'in:1x2')
DRYRUN = ['--nproc', '2', '--data', '1', '--spatial', '2', '--backend',
          'gloo', '--device', 'cuda', '--size', 'full', '--checks',
          'eval,stream,train,zoo', '--train_layouts', ','.join(TRAIN_LAYOUTS)]
# phase 12's bf16 CLI run (no launcher), for the NCCL run's comparison
# and phase 14's TensorBoard check
ENTRY = {}


def phase_streams(net, clip):
    """N bidirectional bf16 streams of 540x960 on one card through one
    StreamDenoiser(batch=N). Stream k is the clip rolled by k frames: the
    checked run pushes all STREAM_T frames and flushes, and each stream's
    output is held by phase 4's PSNR rule against the fp32 MIMO forward
    of its own rolled clip (within 1 dB of the bf16 MIMO forward's PSNR),
    so a fault across the batch (a stride, another stream's state) fails.
    Then the steady ms per push and per frame per stream (TIMED pushes,
    best of 3), the state per stream, the peak memory of the steady pushes
    (and of the checked run, which holds its outputs), and the launches of
    a steady push, which must not grow with N. Returns the checked runs'
    launches."""
    _, noisy = clip
    x1 = _stream_input(noisy)                    # (T, 1, H, W, 4)
    cfg = net.cfg
    refs = []              # stream k: (fp32 MIMO on the host, bf16 dB)
    with torch.no_grad():
        for k in range(max(N_STREAMS)):
            xm = x1.roll(-k, 0)[:, 0][None]
            ref32 = wnet_apply(net.prepared('cuda', torch.float32),
                               xm.float(), cfg)
            mimo16 = wnet_apply(net.prepared('cuda', torch.bfloat16), xm,
                                cfg)
            refs.append((ref32.cpu(), psnr(mimo16, ref32)))
            del ref32, mimo16
    launches = dict.fromkeys(KERNELS, 0)
    for n in N_STREAMS:
        x = torch.cat([x1.roll(-k, 0) for k in range(n)], dim=1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sd = StreamDenoiser(net, None, batch=n, height=H, width=W,
                            dtype=torch.bfloat16)
        lat = sd.latency
        reset_counts()
        outs, steady = [], None
        with _NoConv2d():
            for i in range(STREAM_T):
                before = counts()
                out = sd.push(x[i])
                if i == lat + 1:
                    steady = delta_since(before)
                if out is not None:
                    outs.append(out)
            outs += sd.flush()
        for k, v in counts().items():
            launches[k] += v
        if steady != per_steady_push():
            raise AssertionError(f'{n} streams: a steady push launched '
                                 f'{steady}, not {per_steady_push()}')
        y = torch.stack(outs, dim=1)             # (n, T, H, W, 3)
        if y.shape != (n, STREAM_T, H, W, 3) or not torch.isfinite(y).all():
            raise AssertionError(f'{n} streams: output {tuple(y.shape)}')
        dbs = []
        for k in range(n):
            ref32, mimo_db = refs[k]
            dbs.append(psnr(y[k:k + 1], ref32.cuda()))
            if not dbs[-1] > mimo_db - 1.0:
                raise AssertionError(f'{n} streams: stream {k} {dbs[-1]} dB'
                                     f' vs fp32 MIMO of its clip, bf16 MIMO'
                                     f' {mimo_db} dB')
        del outs, y
        torch.cuda.synchronize()
        checked_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        sd.reset()
        for i in range(lat + 4):
            sd.push(x[i % STREAM_T])
        push_ms = _time_per_frame(sd, x, block=False)
        torch.cuda.synchronize()
        emit({'phase': 'streams', 'streams': n, 'shift_mode': 'TSM',
              'dtype': 'bf16', 'hw': [H, W], 'frames_checked': STREAM_T,
              'psnr_db_vs_fp32_mimo': dbs,
              'mimo_bf16_psnr_db': [refs[k][1] for k in range(n)],
              'ms_per_push': push_ms,
              'ms_per_frame_per_stream': push_ms / n,
              'state_gb_per_stream': _state_bytes(sd.state) / n / 1e9,
              'peak_allocated_gb': torch.cuda.max_memory_allocated() / 1e9,
              'checked_run_peak_allocated_gb': checked_gb,
              'launches_per_steady_push': steady})
        del sd, x
    torch.cuda.empty_cache()
    return launches


def phase_loader_draws():
    """Host ms of one rank's batch assembly and noise (``noisy_batch`` on
    the train yml's 8 x 11 x 96x96 clips a rank, best of 5): its own rows
    (one rank, or a loader of several workers) against the rows of a
    global batch of 8 ranks (one worker, where every rank makes JAX's
    global draws)."""
    clips = np.random.default_rng(SEED).integers(0, 256, (8, 11, 3, 96, 96),
                                                 dtype=np.uint8)
    rec = {'phase': 'loader_draws', 'clips_per_rank': list(clips.shape),
           'host': 'the card machine\'s CPU'}
    for label, total in (('own_rows_ms', None), ('of_8_ranks_ms', (0, 64))):
        best = float('inf')
        for _ in range(5):
            t0 = time.perf_counter()
            noisy_batch(clips, np.random.default_rng(1), [5, 55], 'NF',
                        False, total)
            best = min(best, time.perf_counter() - t0)
        rec[label] = best * 1e3
    emit(rec)


def _sum_launches(total, got):
    for k, v in got.items():
        total[k] += v


def phase_parallel_dryrun():
    """Two gloo ranks that share cuda:0, driven by parallel.dryrun at full
    size: the 544x960 whole clip (fp32, bf16) and stream (fp32, bf16) with
    the rows over both ranks; three fp32 train steps as data 2 x spatial 1
    and data 1 x spatial 2, and two of norm 'bn' (2 x 1, 1 x 2) and of norm
    'in' (1 x 2), their statistics the global batch's; each held against
    the unsharded call on the card (the dryrun asserts: fp32 1e-4 x
    max|ref|, bf16 the PSNR rule, the first step's gradients, every step's
    loss, the parameters' and BN running statistics' gap, the ranks'
    bits). A normed step launches K1, K3, K4 and K7 on every rank, K2
    never. Then StyleGAN2Model and SRModel with a perceptual 'fro' on the
    two ranks, each against its serial run on the card (the dryrun's
    'zoo' check). Returns the sharded runs' launches, summed over the
    ranks."""
    launches = dict.fromkeys(KERNELS, 0)
    out = json.loads(_run_module(['bsvd_tpu_torch.parallel.dryrun',
                                  *DRYRUN], 600)[-1])
    if out['dryrun'] != 'ok' or len(out['ranks']) != 2:
        raise AssertionError(f'parallel.dryrun: {out}')
    note = 'two processes sharing one card: says nothing about scaling'
    for check in ('eval', 'stream'):
        per_rank = [r[check] for r in out['ranks']]
        for r, rec in enumerate(per_rank):
            for dtype in ('float32', 'bfloat16'):
                got = rec[dtype]['launches']
                if got['conv_chain'] != 0 or got['bibuffer_chain'] != 0:
                    raise AssertionError(f'{check} rank {r} {dtype}: K2 / K6 '
                                         f'under the row mask: {got}')
                used = ('conv3x3', 'conv_s2', 'conv_ps') + (
                    ('bibuffer_conv', 'bibuffer_multi') if check == 'stream'
                    else ())
                if not all(got[k] > 0 for k in used):
                    raise AssertionError(f'{check} rank {r} {dtype}: {got}')
                _sum_launches(launches, got)
        emit({'phase': f'parallel_{check}', 'mesh': {'data': 1,
                                                      'spatial': 2},
              'backend': 'gloo', 'ranks_share': 'cuda:0', 'note': note,
              'per_rank': per_rank})
    for i, layout in enumerate(TRAIN_LAYOUTS):
        per_rank = [r['train'][i] for r in out['ranks']]
        normed = ':' in layout
        for rec in per_rank:
            got = rec['launches']
            k1 = got['conv3x3'] + got['shift_conv_fused_v1']
            if not rec['ranks_identical'] or not got['conv3x3_dw'] > 0 or \
                    (normed and not (k1 > 0 and got['conv_s2'] > 0
                                     and got['conv_ps'] > 0
                                     and got['conv_chain'] == 0
                                     and min(rec['all_reduces_per_step'])
                                     > 0)):
                raise AssertionError(f'train {layout}: {rec}')
            _sum_launches(launches, got)
        emit({'phase': 'parallel_train', 'layout_data_x_spatial': layout,
              'backend': 'gloo', 'ranks_share': 'cuda:0', 'note': note,
              'per_rank': per_rank})
    zoo = out['zoo']
    emit({'phase': 'parallel_zoo', 'backend': 'gloo',
          'ranks_share': 'cuda:0', 'note': note,
          'engines': {k: dict(v, per_rank_ms=[r['zoo'][k]['ms']
                                              for r in out['ranks']],
                              ranks_identical=[r['zoo'][k]['ranks_identical']
                                               for r in out['ranks']])
                      for k, v in zoo.items()}})
    if not all(r['zoo'][k]['ranks_identical'] for r in out['ranks']
               for k in zoo):
        raise AssertionError(f'zoo: ranks differ: {out["ranks"]}')
    emit({'phase': 'parallel_dryrun', 'seconds': out['seconds'],
          'argv': DRYRUN})
    if torch.cuda.device_count() >= 2:
        n = torch.cuda.device_count()
        res = subprocess.run(
            [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun',
             '--nproc', str(n), '--data', '1', '--spatial', str(n),
             '--backend', 'nccl', '--device', 'cuda', '--size', 'full'],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f'NCCL dryrun on {n} cards failed: '
                                 f'{res.stderr[-3000:]}')
        emit({'phase': 'parallel_multi_card', 'multi_card': json.loads(
            res.stdout.strip().splitlines()[-1])})
    else:
        emit({'phase': 'parallel_multi_card', 'multi_card': '1 device'})
    return launches


def phase_nccl_train_cli(data):
    """The train CLI under torchrun at world size 1 with --launcher pytorch
    (NCCL), bf16 AMP, NCCL_CLI_ITERS iterations on phase 12's PNG folders:
    the launches, the one checkpoint, ms per iteration beside phase 12's
    run without a launcher. Returns the launches."""
    root = os.path.join(WORK, 'entry_nccl')
    out = os.path.join(WORK, 'nccl_cli.json')
    cmd = _train_cli_cmd(data, '--launcher', 'pytorch',
                         iters=NCCL_CLI_ITERS) + ['train:fp16=true',
                                                  'val:val_freq=~']
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         '1', '--master_addr', '127.0.0.1', '--master_port', str(port),
         os.path.join(ROOT, 'chip_smoke.py'), '--train-cli-rank', root, out,
         *cmd], cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f'torchrun train CLI failed: '
                             f'{res.stderr[-3000:]}')
    with open(out) as f:
        rec = json.load(f)
    run = rec['launches']
    for k in ('conv3x3', 'conv_chain', 'conv_s2', 'conv_ps'):
        if not run[k] > 0:
            raise AssertionError(f'NCCL train CLI: {k} never launched')
    if run['conv3x3_dw'] != PER_TRAIN_STEP['conv3x3_dw'] * NCCL_CLI_ITERS:
        raise AssertionError(f'NCCL train CLI: K7 {run["conv3x3_dw"]}')
    models = os.path.join(root, 'experiments', 'bsvd_c64_unblind', 'models')
    saved = sorted(os.listdir(models))
    if saved != ['net_g_latest.npz'] or rec['backend'] != 'nccl' or \
            rec['world_size'] != 1 or not math.isfinite(rec['loss_last']):
        raise AssertionError(f'NCCL train CLI: {saved} {rec}')
    emit(dict(rec, phase='train_cli_nccl', launcher='torch.distributed.run '
              '--nproc_per_node 1, --launcher pytorch', wall_s=wall,
              checkpoints=saved, no_launcher_steady_3_10=ENTRY.get(
                  'bf16_steady_3_10')))
    return run


def train_cli_rank(root, out, cmd):
    """One torchrun rank of phase 13: the train entry point
    (``train_pipeline``, what ``python -m bsvd_tpu_torch.train`` runs) with
    the launcher's process group, its launches and step clock written to
    ``out``."""
    import torch.distributed as dist
    reset_counts()
    with _StepClock() as clock:
        model = train_pipeline(root, cmd=cmd)
    torch.cuda.synchronize()
    rec = {'backend': dist.get_backend(), 'world_size':
           dist.get_world_size(), 'launches': counts(), 'amp': model.amp,
           'iters': model.optimizer.count,
           'loss_last': model.get_current_log()['l_pix'],
           'steady': clock.steady(3, NCCL_CLI_ITERS)}
    with open(out, 'w') as f:
        json.dump(rec, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 14: the profile entry and its trace, TensorBoard files, frames
# ---------------------------------------------------------------------------

FRAME_FIXTURES = os.path.join(ROOT, 'tests', 'fixtures', 'frames')


def c64_convs():
    """The convs of a c64 forward (options/test/bsvd_c64.yml at 540x960):
    (count, H, W, Cin, Cout, stride) of K1's 16, K2's 4 pairs, K3's 4 and
    K4's 4 launches."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    return [(8, h2, w2, 128, 128, 1), (8, h4, w4, 256, 256, 1),
            (1, H, W, 4, 64, 1), (6, H, W, 64, 64, 1), (1, H, W, 64, 3, 1),
            (2, H, W, 64, 128, 2), (2, h2, w2, 128, 256, 2),
            (2, h4, w4, 256, 512, 1), (2, h2, w2, 128, 256, 1)]


def _taps(n, s):
    """Taps of a 3x3 (pad 1, stride s) axis of n that land inside it,
    counted one by one."""
    return sum(1 for o in range((n - 1) // s + 1) for k in range(3)
               if 0 <= s * o + k - 1 < n)


def _c64_flops():
    """(valid-tap FLOPs, padded FLOPs) of a 10-frame c64 forward."""
    valid = padded = 0
    for n, h, w, ci, co, s in c64_convs():
        valid += n * 2 * ci * co * T * _taps(h, s) * _taps(w, s)
        padded += n * 2 * 9 * ci * co * T * ((h - 1) // s + 1) * \
            ((w - 1) // s + 1)
    return valid, padded


def _profile_entry(net):
    """python -m bsvd_tpu_torch.profile_net --trace at the reference
    protocol, its numbers held to the net and the layer shapes; then its
    trace through parse_trace. Returns the entry's launches."""
    trace_dir = os.path.join(WORK, 'trace')
    t0 = time.perf_counter()
    lines = _run_module(['bsvd_tpu_torch.profile_net', '-opt', TEST_YML,
                         '--trace', '--trace_dir', trace_dir], 600)
    wall = time.perf_counter() - t0
    rec = json.loads(lines[-1])
    heads = ['input shape:', f'time per {T}-frame forward:', 'params:',
             'flops:', 'temp_size_in_bytes:', 'argument_size_in_bytes:',
             'output_size_in_bytes:', 'cuda:0 peak memory:',
             'traced forward:']
    at = [next((i for i, ln in enumerate(lines) if ln.startswith(h)), None)
          for h in heads]
    if None in at or at != sorted(at):
        raise AssertionError(f'profile_net lines out of the reference\'s '
                             f'order: {dict(zip(heads, at))}')
    valid, padded = _c64_flops()
    want_params = count_params(net)
    if padded != KERNEL_SUMS['forward']['flops']:
        raise AssertionError(f'c64_convs padded FLOPs {padded} != phase 2\'s '
                             f'{KERNEL_SUMS["forward"]["flops"]}')
    checks = {'params': rec['params'] == want_params,
              'flops_valid_taps': rec['flops'] == valid,
              'flops_within_1pct_of_padded': 0.99 * padded <= rec['flops']
              <= padded,
              'launches_per_forward': all(
                  rec['launches_per_forward'][k] == PER_FORWARD[k]
                  for k in rec['launches_per_forward']),
              'device': rec['device'] == 'cuda'}
    emit({'phase': 'profile_entry', 'cmd': 'python -m '
          'bsvd_tpu_torch.profile_net -opt options/test/bsvd_c64.yml '
          '--trace', 'wall_s': wall, 'ms_per_forward':
          rec['sec_per_forward'] * 1e3, 'ms_per_frame': rec['ms_per_frame'],
          'phase3_forward_ms_median_of_5':
          MAIN_TIMING['TSM']['forward_ms_median_of_5'],
          'peak_gb': rec['peak_bytes_in_use']['cuda:0'] / 1e9,
          'phase3_peak_gb': MAIN_TIMING['TSM']['peak_allocated_gb'],
          'temp_gb': rec['temp_size_in_bytes'] / 1e9, 'params': rec['params'],
          'flops': rec['flops'], 'flops_valid_taps': valid,
          'flops_padded_phase2': padded, 'valid_over_padded': valid / padded,
          'launches_per_forward': rec['launches_per_forward'],
          'traced_forward_s': rec['traced_forward_s'], 'checks': checks,
          'lines': lines[:-1]})
    if not all(checks.values()):
        raise AssertionError(f'profile_net: {checks}')

    rep = json.loads(_run_module(['bsvd_tpu_torch.tools.parse_trace',
                                  trace_dir, '--group', '--json'], 300)[-1])
    dev = rep['device']
    groups = {g: v['launches'] for g, v in dev['groups'].items()}
    want = {'K1 conv3x3': PER_FORWARD['conv3x3'],
            'K2 conv_chain': PER_FORWARD['conv_chain'],
            'K3 conv_s2': PER_FORWARD['conv_s2'],
            'K4 conv_ps': PER_FORWARD['conv_ps']}
    emit({'phase': 'profile_trace', 'trace': os.path.relpath(rep['trace'],
                                                             WORK),
          'device_busy_ms': dev['busy_ms'], 'device_span_ms': dev['span_ms'],
          'idle_share': dev['idle_share'],
          'groups': dev['groups'], 'top_kernels': dev['kernels'][:6],
          'longest_gaps': dev['gaps'][:3]})
    got = {g: groups.get(g, 0) for g in want}
    if got != want:
        raise AssertionError(f'traced forward launched {got}, not {want}')
    if 'library convolution' in groups:
        raise AssertionError(f'a library convolution ran in the traced '
                             f'forward: {dev["groups"]}')
    return {k: rec['launches'].get(k, 0) for k in KERNELS}


def _tb_check():
    """Phase 12's bf16 train CLI run read back from its tb_logger folder:
    every CRC, losses/l_pix at each print against the text log, the
    validation's metrics."""
    tb = ENTRY['bf16_tb']
    if not tb['files']:
        raise AssertionError('train CLI bf16: no event file in tb_logger')
    scalars = [r for f in tb['files'] for r in tb_events.read_scalars(f)]
    losses = {step: v for _, step, tag, v in scalars if tag == 'losses/l_pix'}
    logged = {}
    with open(tb['log']) as f:
        for line in f:
            m = re.search(r'iter: *([0-9,]+),.* l_pix: ([-+0-9.e]+)', line)
            if m:
                logged[int(m.group(1).replace(',', ''))] = m.group(2)
    want_steps = list(range(10, CLI_ITERS + 1, 10))
    if sorted(losses) != want_steps or sorted(logged) != want_steps:
        raise AssertionError(f'losses/l_pix at {sorted(losses)}, logged at '
                             f'{sorted(logged)}, not {want_steps}')
    # the log prints .4e of the float64 loss, the file holds its float32
    for step in want_steps:
        text = float(logged[step])
        half_unit = 0.5 * 10.0 ** (math.floor(math.log10(abs(text))) - 4)
        if not abs(losses[step] - text) <= half_unit * 1.01 + 1e-7 * abs(text):
            raise AssertionError(f'losses/l_pix at {step}: {losses[step]} in '
                                 f'the file, {logged[step]} in the log')
    metrics = {tag: v for _, step, tag, v in scalars
               if tag.startswith('metrics/') and step == CLI_ITERS}
    want_tags = {'metrics/psnr'} | {f'metrics/psnr/{d}'
                                    for d in tb['val_dirs']}
    if set(metrics) != want_tags or not all(math.isfinite(v)
                                            for v in metrics.values()):
        raise AssertionError(f'metrics at {CLI_ITERS}: {metrics}, want '
                             f'{sorted(want_tags)}')
    emit({'phase': 'tensorboard', 'files': len(tb['files']),
          'scalars': len(scalars), 'losses_l_pix': losses,
          'logged_l_pix': logged, 'metrics': metrics})


def _frames_check():
    """The gray and Adam7 fixtures decoded here against cv2's decodes made
    with them (tests/fixtures/frames/decoded.npz), bit for bit."""
    ref = np.load(os.path.join(FRAME_FIXTURES, 'decoded.npz'))
    names = sorted(f for f in os.listdir(FRAME_FIXTURES)
                   if f.endswith(('.png', '.bmp')))
    done = []
    for f in names:
        path, stem = os.path.join(FRAME_FIXTURES, f), f[:-4]
        mod = png_decode if f.endswith('.png') else bmp_decode
        rgb, gray = mod.load(path), mod.load_gray(path)
        ok = (np.array_equal(rgb, ref[stem])
              and np.array_equal(gray, ref[f'{stem}_gray']))
        if mod is png_decode and min(rgb.shape[:2]) > 2:
            h, w = rgb.shape[:2]
            ok = ok and np.array_equal(
                png_decode.load_crop(path, 1, 1, h - 2, w - 2),
                rgb[1:-1, 1:-1])
        if not ok:
            raise AssertionError(f'{f}: differs from cv2\'s decode')
        done.append(f)
    for f in sorted(os.listdir(JPEG_FIXTURES)):
        if not f.endswith('.jpg'):
            continue
        got = jpeg_decode.load_gray(os.path.join(JPEG_FIXTURES, f))
        if not np.array_equal(got, ref[f'jpeg_{f[:-4]}_gray']):
            raise AssertionError(f'{f}: gray decode differs from cv2\'s')
        done.append(f'{f} (gray)')
    emit({'phase': 'frames_gray_adam7', 'bit_equal': done})


def phase_profile(net):
    """Phase 14. Returns the profile entry's launches."""
    launches = _profile_entry(net)
    _tb_check()
    _frames_check()
    return launches


# ---------------------------------------------------------------------------
# phase 15: the zoo's image-SR family, and BSVD with the perceptual loss
# ---------------------------------------------------------------------------

SR_ARCHS = {
    'MSRResNet_64x16_x4': {'type': 'MSRResNet', 'num_feat': 64,
                           'num_block': 16, 'upscale': 4},
    'EDSR_64x16_x4': {'type': 'EDSR', 'num_feat': 64, 'num_block': 16,
                      'upscale': 4},
    'RRDBNet_64x23x32_x4': {'type': 'RRDBNet', 'num_feat': 64,
                            'num_block': 23, 'num_grow_ch': 32},
    'RCAN_10x20_x4': {'type': 'RCAN', 'num_group': 10, 'num_block': 20},
    'RIDNet': {'type': 'RIDNet'},
}
SR_YMLS = {name: os.path.join(ROOT, 'options', 'train', f'{name}.yml')
           for name in ('msrresnet_x4', 'esrgan_x4')}
# DIV2K's _sub crops (480 x 480 GT, 120 x 120 x4 LQ), 16 of them (one
# batch of the yml's 16); a Set5-layout val set, GT a multiple of 12
SR_TRAIN_N, SR_GT_HW, SR_VAL = 16, 480, ((228, 228), (240, 180),
                                         (156, 204), (180, 240), (204, 156))
SR_ITERS = 20
PERCEPTUAL = ['train:perceptual_opt:type=PerceptualLoss',
              'train:perceptual_opt:layer_weights:conv5_4=1',
              'train:perceptual_opt:vgg_type=vgg19']


def _sr_parity():
    """Each arch at full width, the VGG19 extractor and the VGG-style
    discriminator: the card's fp32 forward (TF32 off) against the CPU's,
    the same weights, within 1e-4 x max|ref|."""
    from bsvd_tpu_torch.archs import build_network as build
    rng = np.random.default_rng(SEED + 40)
    cases = [(name, dict(o, seed=SEED), (2, 3, 64, 64))
             for name, o in SR_ARCHS.items()]
    cases += [('VGG19_conv5_4', {'type': 'VGGFeatureExtractor',
                                 'layer_name_list': ['conv5_4'],
                                 'vgg_type': 'vgg19', 'seed': SEED},
               (2, 3, 128, 128)),
              ('VGGStyleDiscriminator128_eval',
               {'type': 'VGGStyleDiscriminator128', 'seed': SEED},
               (2, 3, 128, 128))]
    out = {}
    for name, o, shape in cases:
        net = build(o, 'cpu').eval()
        if o['type'] == 'RCAN':
            # 200 residual blocks at the JAX init grow the activations to
            # ~1e30, where fp32 rounding alone passes 1e-4 x max|ref|: the
            # RCABs' convs take the MSRResNet / RRDB init family's 0.1
            with torch.no_grad():
                for m in net.body.modules():
                    if hasattr(m, 'rcab'):
                        m.rcab[0].weight.mul_(0.1)
                        m.rcab[2].weight.mul_(0.1)
        x = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
        with torch.no_grad():
            ref = net(x)
            card = copy.deepcopy(net).to('cuda')
            got = card(x.cuda())
        if isinstance(ref, dict):
            ref, got = ref['conv5_4'], got['conv5_4']
        err = (got.float().cpu() - ref).abs().max().item()
        scale = ref.abs().max().item()
        out[name] = {'shape_in': list(shape), 'shape_out': list(ref.shape),
                     'max_abs_err': err, 'max_abs_ref': scale,
                     'params': count_params(net)}
        if not err <= FP32_TOL * scale or not torch.isfinite(got).all():
            raise AssertionError(f'{name}: card vs CPU max |diff| {err} '
                                 f'(max |ref| {scale})')
        del card
    emit({'phase': 'zoo_sr_parity', 'fp32_tf32_off': True,
          'tol': f'{FP32_TOL} x max|ref|', 'nets': out})


def _sr_folders():
    """DIV2K _sub-layout train folders and a Set5-layout val set, written
    with the port's PNG writer (LQ: 4 x 4 area means)."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    root = os.path.join(WORK, 'div2k')
    rng = np.random.default_rng(SEED + 41)
    dirs = {k: os.path.join(root, k) for k in ('train_gt', 'train_lq',
                                               'val_gt', 'val_lq')}
    for d in dirs.values():
        os.makedirs(d)

    def pair(split, i, h, w):
        # smooth colour fields with texture: a coarse grid upscaled, noise
        base = rng.uniform(0, 255, (h // 12 + 2, w // 12 + 2, 3))
        img = F.interpolate(torch.from_numpy(base).permute(2, 0, 1)[None],
                            size=(h, w), mode='bilinear',
                            align_corners=False)[0].permute(1, 2, 0).numpy()
        gt = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).round()
        gt = gt.astype(np.uint8)
        lq = gt.reshape(h // 4, 4, w // 4, 4, 3).mean((1, 3)).round()
        imwrite(gt, os.path.join(dirs[f'{split}_gt'], f'{i:04d}.png'))
        imwrite(lq.astype(np.uint8), os.path.join(dirs[f'{split}_lq'],
                                                  f'{i:04d}.png'))
    t0 = time.perf_counter()
    for i in range(SR_TRAIN_N):
        pair('train', i, SR_GT_HW, SR_GT_HW)
    for i, (h, w) in enumerate(SR_VAL):
        pair('val', i, h, w)
    return dirs, time.perf_counter() - t0


def _sr_cmd(yml, dirs, *force):
    return ['-opt', SR_YMLS[yml], '--force_yml',
            f"datasets:train:dataroot_gt={dirs['train_gt']}",
            f"datasets:train:dataroot_lq={dirs['train_lq']}",
            f"datasets:val:dataroot_gt={dirs['val_gt']}",
            f"datasets:val:dataroot_lq={dirs['val_lq']}",
            f'train:total_iter={SR_ITERS}', 'logger:print_freq=10',
            f'logger:save_checkpoint_freq={SR_ITERS}',
            f'val:val_freq={SR_ITERS + 1}', *force]


def _sr_cli(yml, dirs):
    """The train CLI on a shipped SR yml: 30 iterations at its batch and
    gt_size; ms per iteration (11-30) split into the wait for data and the
    step, peak memory, the validation PSNR and that of the reloaded
    checkpoint."""
    from bsvd_tpu_torch.models.base_model import build_model
    from bsvd_tpu_torch.models.sr_model import SRModel
    from bsvd_tpu_torch.models.srgan_model import SRGANModel
    from bsvd_tpu_torch.train import build_val_loaders
    root = os.path.join(WORK, f'sr_{yml}')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _StepClock((SRModel, SRGANModel)) as clock:
        model = train_pipeline(root, cmd=_sr_cmd(yml, dirs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(clock.marks) != SR_ITERS or model.optimizer.count != SR_ITERS:
        raise AssertionError(f'{yml}: {len(clock.marks)} iterations, '
                             f'optimizer count {model.optimizer.count}')
    opt = model.opt
    loader = build_val_loaders(opt)[0]
    psnr = model.validation(loader, SR_ITERS, None)['psnr']
    exp = os.path.join(root, 'experiments', opt['name'])
    test_opt = copy.deepcopy(opt)
    test_opt['is_train'] = False
    test_opt['path']['pretrain_network_g'] = os.path.join(
        exp, 'models', f'net_g_{SR_ITERS}.npz')
    test_opt['path']['param_key_g'] = ('params_ema' if model.net_g_ema
                                       is not None else 'params')
    reloaded = build_model(test_opt).validation(loader, SR_ITERS,
                                                None)['psnr']
    log = model.get_current_log()
    rec = {'phase': 'zoo_sr_train_cli', 'yml': os.path.relpath(SR_YMLS[yml],
                                                                ROOT),
           'model': type(model).__name__, 'iters': SR_ITERS,
           'batch': opt['datasets']['train']['batch_size_per_gpu'],
           'gt_size': opt['datasets']['train']['gt_size'],
           'network_g_params': count_params(model.net), 'wall_s': wall,
           'steady': clock.steady(11, SR_ITERS), 'peak_allocated_gb': peak,
           'val_psnr': psnr, 'reloaded_val_psnr': reloaded, 'losses': log,
           'fp32_tf32_off': True}
    # the reloaded network's PSNR on the same card: the same to 1e-3 dB
    if not (math.isfinite(psnr) and abs(psnr - reloaded) <= 1e-3 and
            all(math.isfinite(v) for v in log.values())):
        raise AssertionError(f'{yml}: PSNR {psnr} / reloaded {reloaded}, '
                             f'losses {log}')
    if yml == 'esrgan_x4':
        state = torch.load(os.path.join(exp, 'training_states',
                                        f'{SR_ITERS}.state'),
                           weights_only=True)
        files = sorted(os.listdir(os.path.join(exp, 'models')))
        with open(max((os.path.join(exp, f) for f in os.listdir(exp)
                       if f.startswith('train_')), key=os.path.getmtime)) \
                as f:
            warned = 'no pretrained VGG weights' in f.read()
        rec.update(
            network_d_params=count_params(model.net_d),
            ema=model.net_g_ema is not None,
            resume_state={'opt_state_count': state['opt_state']['count'],
                          'opt_state_d_count':
                          state['extra']['opt_state_d']['count']},
            models=files, random_vgg_warned=warned)
        want = {'l_g_pix', 'l_g_percep', 'l_g_gan', 'l_d_real', 'l_d_fake'}
        if not (want <= set(log) and rec['ema'] and warned and
                rec['resume_state'] == {'opt_state_count': SR_ITERS,
                                        'opt_state_d_count': SR_ITERS}
                and f'net_d_{SR_ITERS}.npz' in files):
            raise AssertionError(f'esrgan_x4: {rec}')
    emit(rec)
    return model


def _esrgan_gate(dirs):
    """ESRGANModel from the shipped yml with net_d_init_iters 5, fed by
    its loader: G's parameters the same bits through iteration 5, changed
    at 6; D steps every iteration."""
    from bsvd_tpu_torch.data import build_dataloader
    from bsvd_tpu_torch.models.base_model import build_model
    opt, _ = parse_options(WORK, is_train=True, cmd=_sr_cmd(
        'esrgan_x4', dirs, 'train:net_d_init_iters=5'))
    dopt = opt['datasets']['train']
    loader = build_dataloader(build_dataset(dopt), dopt, num_gpu=1)
    model = build_model(opt)
    g0 = [p.detach().clone() for p in model.net.parameters()]
    same = []
    it = 0
    while it < 6:
        for batch in loader:
            it += 1
            model.feed_data(batch)
            model.optimize_parameters(it)
            same.append(all(torch.equal(a, b) for a, b in
                            zip(g0, model.net.parameters())))
            if it == 6:
                break
    rec = {'phase': 'zoo_esrgan_gate', 'net_d_init_iters': 5,
           'g_unchanged_by_iter': same, 'g_count': model.optimizer.count,
           'd_count': model.optimizer_d.count}
    emit(rec)
    if same != [True] * 5 + [False] or rec['g_count'] != 1 or \
            rec['d_count'] != 6:
        raise AssertionError(f'ESRGAN gate: {rec}')


class _SharedVggMasks:
    """The perceptual loss's discontinuities of one step, recorded in
    call order on one device and used by the same step on the other: the
    VGG's ReLU masks (``x * mask``), its max pools' picks and the sign of
    the l1 criterion's feature differences, counting where that device's
    own differ. A value
    within rounding of 0 takes the other side on the other device, as the
    WNet's masks do (``_SharedMasks``). ``feats`` keeps the features each
    device gave the criterion (x's and gt's, float64 on the host): the
    card's first, then the other device's."""

    def __init__(self):
        self.masks, self.signs = [], []
        self.flips = self.sign_flips = self.pool_flips = 0
        self.handles, self.loss, self.criterion = [], None, None
        self.feats = {True: [], False: []}

    def _record(self, module, inp, out):
        self.masks.append(out > 0)

    def _replay(self, module, inp, out):
        mask = self.masks.pop(0).to(out.device)
        self.flips += int(((out > 0) != mask).sum())
        return inp[0] * mask

    def _pool_record(self, module, inp, out):
        _, idx = F.max_pool2d(inp[0], module.kernel_size, module.stride,
                              return_indices=True)
        self.masks.append(idx)

    def _pool_replay(self, module, inp, out):
        idx = self.masks.pop(0).to(out.device)
        _, own = F.max_pool2d(inp[0], module.kernel_size, module.stride,
                              return_indices=True)
        self.pool_flips += int((own != idx).sum())
        x = inp[0].flatten(2)
        return x.gather(2, idx.flatten(2)).view_as(out)

    def _keep(self, record, a, b):
        self.feats[record].append((a.detach().double().cpu(),
                                   b.detach().double().cpu()))

    def _l1_record(self, a, b):
        self._keep(True, a, b)
        self.signs.append(torch.sign(a - b).detach())
        return (a - b).abs().mean()

    def _l1_replay(self, a, b):
        self._keep(False, a, b)
        sign = self.signs.pop(0).to(a.device)
        self.sign_flips += int((torch.sign(a - b) != sign).sum())
        return ((a - b) * sign).mean()

    def on(self, model, record):
        hooks = {torch.nn.ReLU: (self._record, self._replay),
                 torch.nn.MaxPool2d: (self._pool_record, self._pool_replay)}
        self.loss = model.cri_perceptual
        self.handles = [m.register_forward_hook(hooks[type(m)][not record])
                        for m in self.loss.vgg.vgg_net if type(m) in hooks]
        if self.loss.criterion_type != 'l1':
            raise AssertionError('the shared signs are the l1 criterion\'s')
        self.criterion = self.loss.criterion
        self.loss.criterion = self._l1_record if record else self._l1_replay
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.loss.criterion = self.criterion


def _percep_gap(vgg_masks, card_loss, cpu_loss):
    """l_percep of the card and of the CPU beside what they were computed
    from: the conv5_4 features of x each device gave the l1 criterion
    (their max gap over max|CPU's|), and the criterion's mean recomputed
    in float64 from each device's features. Fails where the CPU's
    features are the card's bits: the two sides would not be computed
    apart. Two fp32 losses whose float64 means differ by less than the
    spacing of fp32 numbers there may round to the same bits."""
    (ca, cb), = vgg_masks.feats[True]
    (pa, pb), = vgg_masks.feats[False]
    card64 = float((ca - cb).abs().mean())
    cpu64 = float((pa - pb).abs().mean())
    gap = {'card': card_loss, 'cpu': cpu_loss,
           'card_hex': float(card_loss).hex(), 'cpu_hex': float(cpu_loss).hex(),
           'conv5_4_shape': list(pa.shape),
           'conv5_4_x_max_gap': float((ca - pa).abs().max()
                                      / pa.abs().max()),
           'conv5_4_x_minus_gt_max_gap': float(((ca - cb) - (pa - pb)).abs()
                                               .max() / (pa - pb).abs().max()),
           'card_f64_mean': card64, 'cpu_f64_mean': cpu64,
           'f64_mean_rel_gap': abs(card64 - cpu64) / abs(cpu64),
           'fp32_spacing_rel': float(np.spacing(np.float32(cpu_loss))
                                     / np.float32(cpu_loss))}
    if not gap['conv5_4_x_max_gap'] > 0:
        raise AssertionError(f'perceptual step: the CPU\'s conv5_4 features '
                             f'are the card\'s bits: {gap}')
    return gap


def _perceptual_opt(t_len, amp):
    opt, _ = parse_options(WORK, is_train=True, cmd=[
        '-opt', TRAIN_YML, '--force_yml', f'network_g:num_segments={t_len}',
        f'train:fp16={str(amp).lower()}', 'train:ema_decay=0', *PERCEPTUAL])
    return opt


def _bsvd_perceptual():
    """The c64 train step of phase 8 (batch 8 x 11 x 96 x 96, bf16 AMP)
    with the VGG19 conv5_4 perceptual loss: launches per step, the loss
    terms, ms per step beside phase 8's plain bf16 step, peak memory; then
    phase 7's fp32 step card against CPU with the loss. Returns the
    launches."""
    per_step = {k: PER_TRAIN_STEP.get(k, 0) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    batch = _train_batch(np.random.default_rng(SEED + 5), TRAIN_N, TRAIN_T,
                         TRAIN_HW)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DenoisingModel(_perceptual_opt(TRAIN_T, True), device='cuda')
    model.feed_data(batch)
    reset_counts()
    _time_steps(model, 2, 1)
    reset_counts()
    ms, _ = _time_steps(model, 10, 3)
    run = counts()
    for k, v in run.items():
        if v != per_step[k] * 10:
            raise AssertionError(f'perceptual step: {k} launched {v} times '
                                 f'in 10 steps')
        launches[k] += v
    log = model.get_current_log()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    # phase 7's fp32 step, card against CPU, the WNet's masks shared
    opt = _perceptual_opt(GRAD_T, False)
    gbatch = _train_batch(np.random.default_rng(SEED + 4), GRAD_N, GRAD_T,
                          GRAD_HW)
    card = DenoisingModel(copy.deepcopy(opt), device='cuda')
    cpu = DenoisingModel(copy.deepcopy(opt), device='cpu')
    masks, vgg_masks = _SharedMasks(), _SharedVggMasks()
    card.feed_data(gbatch)
    reset_counts()
    with masks.record(), vgg_masks.on(card, True):
        card.optimize_parameters(1)
    for k, v in counts().items():
        launches[k] += v
    cpu.feed_data(gbatch)
    with masks.replay(), vgg_masks.on(cpu, False):
        cpu.optimize_parameters(1)
    if vgg_masks.masks or vgg_masks.signs:
        raise AssertionError(f'{len(vgg_masks.masks)} VGG masks, '
                             f'{len(vgg_masks.signs)} signs not used')
    cl, rl = card.get_current_log(), cpu.get_current_log()
    errs = {k: abs(cl[k] - rl[k]) / abs(rl[k]) for k in rl}
    percep = _percep_gap(vgg_masks, cl['l_percep'], rl['l_percep'])
    cpu_named = dict(cpu.net.named_parameters())
    grad_errs = {n: _max_rel(p.grad, cpu_named[n].grad)
                 for n, p in card.net.named_parameters()}
    worst = max(grad_errs, key=grad_errs.get)
    rec = {'phase': 'zoo_bsvd_perceptual', 'perceptual_opt': PERCEPTUAL,
           'batch': [TRAIN_N, TRAIN_T, TRAIN_HW, TRAIN_HW], 'amp': True,
           'launches_per_step': per_step, 'losses': log, 'ms_per_step': ms,
           'phase8_plain_bf16_ms_per_step': TRAIN_MS.get(True),
           'peak_allocated_gb': peak,
           'grad_check': {'batch': [GRAD_N, GRAD_T, GRAD_HW, GRAD_HW],
                          'loss_rel_err': errs,
                          'grad_max_rel_err': [worst, grad_errs[worst]],
                          'tensors': len(grad_errs),
                          'mask_flips': masks.flips,
                          'vgg_mask_flips': vgg_masks.flips,
                          'l1_sign_flips': vgg_masks.sign_flips,
                          'pool_flips': vgg_masks.pool_flips,
                          'l_percep': percep,
                          'worst_5': sorted(grad_errs.items(),
                                            key=lambda kv: -kv[1])[:5],
                          'tol': FP32_TOL}}
    emit(rec)
    if list(log) != ['l_pix', 'l_percep'] or not all(
            math.isfinite(v) for v in log.values()):
        raise AssertionError(f'perceptual step losses {log}')
    for what, e in list(errs.items()) + list(grad_errs.items()):
        if not e <= FP32_TOL:
            raise AssertionError(f'perceptual step card vs CPU: {what} max '
                                 f'rel err {e}')
    return launches


def _sr_loader_rates(dirs):
    """Batches a second of the msrresnet_x4 train loader (BatchLoader of
    PairedImageDataset, batch 16, gt_size 128) with 1 and 4 workers (the
    dataset reads serially either way: one RNG draws every crop)."""
    from bsvd_tpu_torch.data import build_dataloader
    opt, _ = parse_options(WORK, is_train=True, cmd=_sr_cmd('msrresnet_x4',
                                                             dirs))
    rates = []
    for workers in (1, 4):
        # 4 batches an epoch, 2 epochs after a first one
        dopt = dict(opt['datasets']['train'], num_worker_per_gpu=workers,
                    dataset_enlarge_ratio=4)
        loader = build_dataloader(build_dataset(dopt), dopt, num_gpu=1)
        for batch in loader:
            pass
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for batch in loader:
                n += 1
        secs = time.perf_counter() - t0
        rates.append({'workers': workers, 'batch': list(batch['gt'].shape),
                      'batches_per_s': n / secs, 'batches': n,
                      'dataset_enlarge_ratio': 4})
    return rates


def phase_zoo_sr():
    """Phase 15. Returns the BSVD perceptual steps' launches."""
    _sr_parity()
    dirs, write_s = _sr_folders()
    emit({'phase': 'zoo_sr_data', 'write_s': write_s,
          'train': [SR_TRAIN_N, SR_GT_HW, SR_GT_HW], 'val': SR_VAL})
    for yml in SR_YMLS:
        _sr_cli(yml, dirs)
    _esrgan_gate(dirs)
    emit({'phase': 'zoo_sr_loader', 'cpu_count': os.cpu_count(),
          'rates': _sr_loader_rates(dirs)})
    return _bsvd_perceptual()


# ---------------------------------------------------------------------------
# phase 16: mp4 clips on NVDEC, the NV12 -> RGB kernel, the train CLI
# ---------------------------------------------------------------------------

# fixture kinds held to the writer's planes: name -> (W, H, frames, writer
# options); the train folder: MP4_CLIPS clips of TRAIN_FRAMES frames at
# DAVIS's 854 x 480 (coded 864 x 480)
MP4_FIXTURES = {
    'idr_p': (320, 240, 24, dict(gop=8)),
    'cropped_854x480': (854, 480, 24, dict(gop=8)),
    'bframes_elst': (416, 234, 24, dict(gop=12, bframes=True,
                                        profile=mvf.HIGH)),
}
MP4_CLIPS = 4
# the kernel's windows: (y0, x0) odd and even, and the far corner
MP4_WINDOWS = ((0, 0), (1, 1), (0, 1), (1, 0),
               (TRAIN_FRAME_HW[0] - TRAIN_HW, TRAIN_FRAME_HW[1] - TRAIN_HW))
MP4_LOADER_BATCHES = 3
NV12_RGB = ('nv12_rgb', 'bsvd_tpu_torch/csrc/nv12_rgb.cu',
            'bsvd_tpu/data/video_train_loader.py:122')


def _mp4_errors():
    """Each refusal names its cause: an mp4 on the CPU (NVDEC), a missing
    libnvcuvid (in a fresh process), H.264 NVDEC does not decode
    (cuvidGetDecoderCaps). Returns (record, whether NVDEC is exposed to
    this process). It counts as hidden only on ``nvdec.NvdecNotExposed``
    (cuvidGetDecoderCaps out of memory where NVIDIA_DRIVER_CAPABILITIES
    lacks 'video'); any other failure of the 4:2:0 8-bit query, its
    format refused included, fails the phase."""
    rec = {}
    try:
        nvdec.require('cpu')
        raise AssertionError('an mp4 on the CPU was not refused')
    except NotImplementedError as e:
        if 'NVDEC' not in str(e):
            raise AssertionError(f'CPU refusal does not name NVDEC: {e}')
        rec['cpu'] = str(e)
    code = ('from bsvd_tpu_torch.data import nvdec\n'
            'nvdec.NVCUVID = "libnvcuvid_absent.so.1"\n'
            'try:\n    nvdec.lib()\n'
            'except nvdec.NvdecError as e:\n    print("REFUSED", e)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    if 'REFUSED libnvcuvid_absent.so.1 not found' not in res.stdout:
        raise AssertionError(f'missing libnvcuvid not named: {res.stdout}'
                             f'{res.stderr[-2000:]}')
    rec['missing_library'] = res.stdout.strip()
    rec['NVIDIA_DRIVER_CAPABILITIES'] = os.environ.get(
        'NVIDIA_DRIVER_CAPABILITIES')
    caps = {}
    try:
        caps['1_8'] = nvdec.caps('cuda', 1, 8)
        exposed = True
    except nvdec.NvdecNotExposed as e:
        caps['1_8'], exposed = str(e), False
    for chroma, depth in ((3, 8), (2, 8), (1, 10)):
        try:
            caps[f'{chroma}_{depth}'] = nvdec.caps('cuda', chroma, depth)
        except nvdec.NvdecError as e:
            if 'cuvidGetDecoderCaps' not in str(e):
                raise AssertionError(f'caps refusal not named: {e}')
            caps[f'{chroma}_{depth}'] = str(e)
    rec['caps'] = caps
    if exposed and not any(isinstance(v, str) for v in caps.values()):
        raise AssertionError(f'no H.264 format refused by '
                             f'cuvidGetDecoderCaps: {caps}')
    rec['nvdec_exposed'] = exposed
    return rec, exposed


def _mp4_decode_check(root, exposed):
    """Each fixture kind from every start: libnvcuvid's parser (its
    sequence against the SPS, one picture per access unit, the display
    order of the demuxer's window); where NVDEC is exposed, its NV12 equal
    to the writer's planes and its frames a second on the 854 x 480 clip.
    Returns the 854 x 480 clip's NV12 on the card (NVDEC's, else the
    writer's, for the kernel's comparison only) and the record."""
    rec, planes854 = {}, None
    for i, (name, (w, h, n, kw)) in enumerate(MP4_FIXTURES.items()):
        path = os.path.join(root, f'{name}.mp4')
        want = torch.from_numpy(mvf.nv12(*mvf.write_clip(
            path, SEED + 160 + i, w, h, n, **kw))).cuda()
        track = mp4_demux.open_track(path)
        parsed = 0
        t0 = time.perf_counter()
        for start in range(n):
            count = min(TRAIN_T, n - start)
            first, last = track.window_samples(start, count)
            fed = track.disp_index[first:last + 1]
            got = nvdec.parse(track, start, count)
            if got['decoded'] != len(fed) or got['shown'] != sorted(
                    fed[fed >= 0].tolist()) or not got['window']:
                raise AssertionError(f'libnvcuvid parser {name}@{start}: '
                                     f'{got} for samples {fed.tolist()}')
            parsed += got['decoded']
        r = {'hw': [h, w], 'coded_hw': list(track.coded_hw), 'frames': n,
             'sync_samples': int(track.sync.sum()),
             'bytes_per_frame': float(track.sizes.mean()),
             'parser_starts_checked': n,
             'parser_frames_per_s': parsed / (time.perf_counter() - t0),
             'min_num_decode_surfaces': got['min_surfaces']}
        clip = want
        if exposed:
            nv, clip = _nvdec_planes(track, want, name, n)
            r.update(nv)
        else:
            dec = nvdec.Decoder('cuda')
            try:
                dec.decode(track, 0, 1)
                raise AssertionError('NVDEC decoded where caps refused it')
            except nvdec.NvdecNotExposed as e:
                r['decode'] = f'not run: {e}'
            finally:
                dec.close()
        rec[name] = r
        if (h, w) == TRAIN_FRAME_HW:
            planes854 = clip
    return planes854, rec


def _nvdec_planes(track, want, name, n):
    """NVDEC's NV12 from every start equal to the writer's; its frames a
    second decoding the whole clip. Returns (record, the whole clip)."""
    dec = nvdec.Decoder('cuda')
    try:
        before = nvdec.frames_decoded
        for start in range(n):
            count = min(TRAIN_T, n - start)
            got = dec.decode(track, start, count)
            if not torch.equal(got, want[start:start + count]):
                bad = (got != want[start:start + count]).nonzero()[:3]
                raise AssertionError(f'NVDEC {name}@{start}: planes differ '
                                     f'from the writer\'s at {bad.tolist()}')
        decoded = nvdec.frames_decoded - before
        t0 = time.perf_counter()
        for _ in range(5):
            clip = dec.decode(track, 0, n)
        torch.cuda.synchronize()
        whole_s = (time.perf_counter() - t0) / 5
    finally:
        dec.close()
    if not torch.equal(clip, want):
        raise AssertionError(f'NVDEC {name}: the whole clip differs')
    return {'decode': 'nvdec', 'starts_checked': n, 'frames_decoded': decoded,
            'whole_clip_frames_per_s': n / whole_s}, clip


def _mp4_kernel_check(nv12):
    """nv12_rgb against its plain version on the card, bit for bit, at
    odd and even windows and the whole frame; both timed on one train
    window, beside its bound."""
    t = TRAIN_T
    frames = nv12[:t].contiguous()
    h, w = TRAIN_FRAME_HW
    before = yuv.nv12_to_rgb.launches
    cases = [(y0, x0, TRAIN_HW, TRAIN_HW) for y0, x0 in MP4_WINDOWS]
    cases.append((0, 0, h, w))
    for y0, x0, ch, cw in cases:
        got = yuv.nv12_to_rgb(frames, y0, x0, ch, cw)
        ref = yuv.nv12_to_rgb_plain(frames, y0, x0, ch, cw)
        if not torch.equal(got, ref):
            raise AssertionError(f'nv12_rgb differs from its plain version '
                                 f'at {(y0, x0, ch, cw)}: max '
                                 f'{(got.int() - ref.int()).abs().max()}')
    y0, x0 = MP4_WINDOWS[1]
    ms = median_ms(lambda: yuv.nv12_to_rgb(frames, y0, x0, TRAIN_HW,
                                           TRAIN_HW), reps=50, warmup=5)
    plain_ms = median_ms(lambda: yuv.nv12_to_rgb_plain(
        frames, y0, x0, TRAIN_HW, TRAIN_HW), reps=50, warmup=5)
    n_bytes = yuv.window_bytes(t, y0, x0, TRAIN_HW, TRAIN_HW)
    yuv.nv12_to_rgb.launches = before      # comparisons are not the path
    return {'cases': len(cases), 'max_abs_err': 0, 'ms': ms,
            'plain_ms': plain_ms, 'bytes': n_bytes,
            'bound_ms': n_bytes / PEAK_BYTES * 1e3, 'bound_by': 'bytes',
            'library_ms': None,
            'per': f'one {t} x {TRAIN_HW} x {TRAIN_HW} window of an '
                   f'{h} x {w} NV12 clip'}


def _mp4_folders(root):
    """MP4_CLIPS synthetic 854 x 480 mp4 clips, and the same RGB frames
    (cv2's conversion of the writer's planes) as PNG folders."""
    mp4_dir, png_dir = os.path.join(root, 'mp4'), os.path.join(root, 'png')
    os.makedirs(mp4_dir)
    h, w = TRAIN_FRAME_HW
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for i in range(MP4_CLIPS):
            path = os.path.join(mp4_dir, f'clip{i:02d}.mp4')
            nv12 = mvf.nv12(*mvf.write_clip(path, SEED + 170 + i, w, h,
                                            TRAIN_FRAMES, gop=8))
            rgb = yuv.nv12_to_rgb_plain(torch.from_numpy(nv12).cuda(), 0, 0,
                                        h, w).cpu().numpy()
            _write_clip(os.path.join(png_dir, f'clip{i:02d}'), rgb, pool)
    return mp4_dir, png_dir, time.perf_counter() - t0


def _mp4_loader_equal(mp4_dir, png_dir, data):
    """The yml's loader (one worker, the same seed) over the mp4 folder and
    over the PNG folders of the same RGB frames: the same batches. Returns
    the mp4 loader's nv12_rgb launches and K1-K7 launches (none)."""
    batches = {}
    launches = {}
    for kind, folder in (('png', png_dir), ('mp4', mp4_dir)):
        opt, _ = parse_options(WORK, is_train=True, cmd=_train_cli_cmd(
            dict(data, train=folder)))
        dopt = dict(opt['datasets']['train'], manual_seed=opt['manual_seed'],
                    num_workers=1, device='cuda')
        reset_counts()
        yuv.nv12_to_rgb.launches = 0
        loader = build_dataset(dopt)
        try:
            it = iter(loader)
            batches[kind] = [next(it) for _ in range(MP4_LOADER_BATCHES)]
        finally:
            loader.close()
        launches[kind] = yuv.nv12_to_rgb.launches
    for i, (a, b) in enumerate(zip(batches['mp4'], batches['png'])):
        if sorted(a) != sorted(b) or not all(
                np.array_equal(a[k], b[k]) for k in b):
            raise AssertionError(f'mp4 batch {i} differs from the PNG '
                                 f'folders\' batch')
    if launches['png'] or not launches['mp4'] >= \
            MP4_LOADER_BATCHES * TRAIN_N:
        raise AssertionError(f'nv12_rgb launches {launches}')
    return launches['mp4']


def _mp4_cli(mp4_dir, data):
    """The train CLI on the shipped yml over the mp4 folder: bf16 AMP,
    CLI_ITERS iterations, one validation of JPEG_VAL_T frames a clip at
    the end. Returns (record, K1-K7 launches, nv12_rgb launches)."""
    root = os.path.join(WORK, 'entry_mp4')
    cmd = _train_cli_cmd(dict(data, train=mp4_dir)) + [
        'train:fp16=true', f'datasets:val:num_validation_frames={JPEG_VAL_T}']
    reset_counts()
    yuv.nv12_to_rgb.launches = 0
    decoded = nvdec.frames_decoded
    t0 = time.perf_counter()
    with _NoConv2d(), _ValSeconds() as secs, _StepClock() as clock:
        model = train_pipeline(root, cmd=cmd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run, conv = counts(), yuv.nv12_to_rgb.launches
    step_kernels = ('conv3x3', 'conv_chain', 'conv_s2', 'conv_ps',
                    'conv3x3_dw')
    for k in step_kernels:
        if not run[k] >= PER_TRAIN_STEP[k] * CLI_ITERS:
            raise AssertionError(f'train CLI on mp4: {k} launched '
                                 f'{run[k]} times in {CLI_ITERS} steps')
    if run['conv3x3_dw'] != PER_TRAIN_STEP['conv3x3_dw'] * CLI_ITERS or \
            model.optimizer.count != CLI_ITERS or not conv >= \
            CLI_ITERS * TRAIN_N or len(clock.marks) != CLI_ITERS or not \
            nvdec.frames_decoded - decoded >= CLI_ITERS * TRAIN_N * TRAIN_T:
        raise AssertionError(f'train CLI on mp4: K7 {run["conv3x3_dw"]}, '
                             f'optimizer count {model.optimizer.count}, '
                             f'nv12_rgb {conv}, {len(clock.marks)} clocked, '
                             f'{nvdec.frames_decoded - decoded} decoded')
    rec = {'phase': 'train_cli', 'run': 'bf16_mp4', 'amp': model.amp,
           'iters': CLI_ITERS, 'wall_s': wall, 'launches': run,
           # a step's launches (K7's checked exactly above); the rest are
           # the validations'
           'launches_per_step': {k: PER_TRAIN_STEP[k] for k in step_kernels},
           'validation_launches': {k: run[k] - PER_TRAIN_STEP[k] * CLI_ITERS
                                   for k in step_kernels},
           'nv12_rgb_launches': conv,
           'nvdec_frames': nvdec.frames_decoded - decoded,
           'validations': len(secs.runs),
           'loss_last': model.get_current_log()['l_pix'],
           'steady': clock.steady(11, CLI_ITERS),
           'steady_3_10': clock.steady(3, JPEG_CLI_ITERS),
           'png_bf16_steady': ENTRY.get('bf16_steady'),
           'png_bf16_steady_3_10': ENTRY.get('bf16_steady_3_10'),
           'jpeg_bf16_steady_3_10': ENTRY.get('jpeg_steady_3_10')}
    if not math.isfinite(rec['loss_last']):
        raise AssertionError('train CLI on mp4: non-finite loss')
    del model
    return rec, run, conv


def _mp4_loader_rates(mp4_dir, data):
    """Batches a second of the yml's loader over the mp4 folder with 1 and
    8 workers (after the first batch), and NVDEC's frames a second then."""
    rates = []
    for workers, batches in ((1, 3), (8, 6)):
        before = nvdec.frames_decoded
        t0 = time.perf_counter()
        rate = _loader_rate(dict(data, train=mp4_dir), workers, batches)
        rate['nvdec_frames'] = nvdec.frames_decoded - before
        rate['nvdec_frames_per_s_whole_run'] = rate['nvdec_frames'] / (
            time.perf_counter() - t0)
        rates.append(rate)
    return rates


def phase_mp4(data):
    """Phase 16. Returns (K1-K7 launches of the CLI run, the nv12_rgb
    record for the kernels line). Where NVDEC is hidden from the process
    the mp4 loader and CLI runs cannot decode: they are reported as not
    run, and nv12_rgb's main-path launches are 0."""
    root = os.path.join(WORK, 'mp4')
    os.makedirs(root)
    errors, exposed = _mp4_errors()
    rec = {'phase': 'mp4', 'errors': errors}
    planes854, rec['decode'] = _mp4_decode_check(root, exposed)
    kernel = _mp4_kernel_check(planes854)
    rec['nv12_rgb'] = kernel
    if not exposed:
        why = f'not run: {errors["caps"]["1_8"]}'
        kernel.update(launches=0, main_path=why)
        rec.update(loader_equals_png=why, train_cli=why, loader_rates=why)
        emit(rec)
        name, src, rep = NV12_RGB
        return {k: 0 for k in KERNELS}, dict(kernel, name=name, source=src,
                                             replaces=rep)
    mp4_dir, png_dir, rec['write_s'] = _mp4_folders(root)
    kernel['launches'] = _mp4_loader_equal(mp4_dir, png_dir, data)
    kernel['main_path'] = 'the mp4 loader and the train CLI'
    rec['loader_equals_png'] = True
    emit(rec)
    cli, run, conv = _mp4_cli(mp4_dir, data)
    emit(cli)
    kernel['launches'] += conv
    emit({'phase': 'mp4_loader', 'cpu_count': os.cpu_count(),
          'rates': _mp4_loader_rates(mp4_dir, data)})
    name, src, rep = NV12_RGB
    return run, dict(kernel, name=name, source=src, replaces=rep)


# ---------------------------------------------------------------------------
# phase 17: the zoo's recurrent video SR (BasicVSR) from basicvsr_reds.yml
# ---------------------------------------------------------------------------

VSR_YML = os.path.join(ROOT, 'options', 'train', 'basicvsr_reds.yml')
# REDS-layout train clips, (clips, frames, GT H, GT W): enough frames for
# the yml's num_frame 15, GT over its gt_size 256; REDS4-layout val clips
# at half REDS4's size (LQ 90 x 160)
VSR_TRAIN, VSR_VAL = (2, 20, 256, 320), (2, 15, 360, 640)
VSR_ITERS, VSR_RESUME_ITERS, VSR_FIX_FLOW = 20, 25, 10
VSR_NET = {'type': 'BasicVSR', 'num_feat': 64, 'num_block': 30}


def _vsr_clips(root, clips, frames, h, w, rng, pool):
    """clips x frames GT PNGs of h x w, a smooth textured field moving up
    to 4 px a frame, and their 4x4-mean LQs, in REDS's layout
    (<root>/gt/<clip>/<8 digits>.png, <root>/lq/...); returns the
    writes' futures."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    futures, margin = [], 4 * frames
    for c in range(clips):
        dy, dx = rng.integers(-4, 5, 2)
        hh, ww = h + 2 * margin, w + 2 * margin
        base = rng.uniform(0, 255, (3, hh // 16 + 2, ww // 16 + 2))
        field = F.interpolate(torch.from_numpy(base)[None], size=(hh, ww),
                              mode='bilinear', align_corners=False)[0]
        field = np.clip(field.permute(1, 2, 0).numpy()
                        + rng.normal(0, 8, (hh, ww, 3)), 0, 255)
        field = field.round().astype(np.uint8)
        for i in range(frames):
            y0, x0 = margin + i * dy, margin + i * dx
            gt = np.ascontiguousarray(field[y0:y0 + h, x0:x0 + w])
            lq = gt.reshape(h // 4, 4, w // 4, 4, 3).mean((1, 3)).round()
            for tree, img in (('gt', gt), ('lq', lq.astype(np.uint8))):
                futures.append(pool.submit(imwrite, img, os.path.join(
                    root, tree, f'{c:03d}', f'{i:08d}.png')))
    return futures


def _vsr_parity():
    """One full-width BasicVSR forward (5 frames of 64 x 64), the card's
    fp32 (TF32 off) against the CPU's on the same weights, within 1e-4 x
    max|ref|."""
    net = build_network(dict(VSR_NET, seed=SEED), 'cpu').eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 51).uniform(
        0, 1, (1, 5, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ref = net(x)
        got = copy.deepcopy(net).to('cuda')(x.cuda()).cpu()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rec = {'phase': 'zoo_vsr_parity', 'net': VSR_NET,
           'shape_in': list(x.shape), 'shape_out': list(ref.shape),
           'max_abs_err': err, 'max_abs_ref': scale,
           'tol': f'{FP32_TOL} x max|ref|', 'fp32_tf32_off': True,
           'params': count_params(net)}
    emit(rec)
    if not err <= FP32_TOL * scale or not torch.isfinite(got).all():
        raise AssertionError(f'BasicVSR card vs CPU: {rec}')


def _vsr_cmd(root, iters, *extra):
    return ['-opt', VSR_YML, *extra, '--force_yml',
            f'datasets:train:dataroot_gt={root}/train/gt',
            f'datasets:train:dataroot_lq={root}/train/lq',
            f'datasets:val:dataroot_gt={root}/val/gt',
            f'datasets:val:dataroot_lq={root}/val/lq',
            'network_g:spynet_path=~', f'train:total_iter={iters}',
            f'train:fix_flow={VSR_FIX_FLOW}', 'logger:print_freq=10',
            f'logger:save_checkpoint_freq={VSR_ITERS}',
            # past both runs: each validates once, after its last iteration
            f'val:val_freq={VSR_RESUME_ITERS + 1}']


def _vsr_profile(model, dopt, n=1):
    """The device profile of n more train steps of the CLI's model on one
    item of its train dataset (after the CLI's run: its saved state is
    what the resume reads)."""
    item = build_dataset(dopt)[0]
    model.feed_data({'lq': item['lq'][None], 'gt': item['gt'][None]})

    def run():
        for i in range(n):
            model.optimize_parameters(VSR_ITERS + 1 + i)
        torch.cuda.synchronize()
    run()                                   # the same shapes, warm
    prof = device_profile(run, n, 'vsr_steps')
    prof.pop('by_kernel')
    prof['top_device_ms_per_unit'] = prof['top_device_ms_per_unit'][:8]
    return prof


def _vsr_cli(root):
    """The train CLI on basicvsr_reds.yml at its widths, batch, num_frame
    and gt_size for VSR_ITERS iterations (SpyNet frozen before
    VSR_FIX_FLOW), then --auto_resume to VSR_RESUME_ITERS."""
    from bsvd_tpu_torch.models.video_recurrent_model import \
        VideoRecurrentModel as VRM
    snaps, orig, vals = {}, VRM.optimize_parameters, []
    validation, own = VRM.validation, VRM.__dict__.get('validation')

    def timed_validation(model, loader, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = validation(model, loader, *a, **k)
        torch.cuda.synchronize()
        vals.append((res, (time.perf_counter() - t0) / len(loader.dataset),
                     len(loader.dataset)))
        return res

    def watched(model, it):
        first = model.net.spynet.basic_module[0].basic_module[0].weight
        if it == 1:
            snaps[0] = first.detach().clone()
        orig(model, it)
        if it in (VSR_FIX_FLOW - 1, VSR_FIX_FLOW):
            snaps[it] = first.detach().clone()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    VRM.optimize_parameters = watched
    VRM.validation = timed_validation
    try:
        t0 = time.perf_counter()
        with _StepClock((VRM,)) as clock:
            model = train_pipeline(root, cmd=_vsr_cmd(root, VSR_ITERS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        VRM.optimize_parameters = orig
        if own is None:
            del VRM.validation
        else:
            VRM.validation = own
    peak = torch.cuda.max_memory_allocated() / 1e9
    opt = model.opt
    # the run's one validation (val_freq is its last iteration)
    (res, val_s, n_val), = vals
    psnr = res['psnr']
    exp = os.path.join(root, 'experiments', opt['name'])
    ckpt = os.path.join(exp, 'models', f'net_g_{VSR_ITERS}.npz')
    dopt = opt['datasets']['train']
    rec = {'phase': 'zoo_vsr_train_cli',
           'yml': os.path.relpath(VSR_YML, ROOT),
           'model': type(model).__name__, 'net': opt['network_g'],
           'iters': VSR_ITERS, 'batch': dopt['batch_size_per_gpu'],
           'num_frame': dopt['num_frame'], 'gt_size': dopt['gt_size'],
           'lq_hw': [dopt['gt_size'] // opt['scale']] * 2,
           'fix_flow': VSR_FIX_FLOW,
           'network_g_params': count_params(model.net), 'wall_s': wall,
           'steady': clock.steady(11, VSR_ITERS),
           'peak_allocated_gb': peak, 'val_psnr': psnr,
           'val_s_per_clip': val_s,
           'val_clips': [n_val, VSR_VAL[1],
                         VSR_VAL[2] // 4, VSR_VAL[3] // 4],
           'checkpoint': os.path.relpath(ckpt, WORK),
           'checkpoint_mb': os.path.getsize(ckpt) / 1e6,
           'spynet_frozen_through': torch.equal(snaps[0],
                                                snaps[VSR_FIX_FLOW - 1]),
           'spynet_moved_at_fix_flow': not torch.equal(
               snaps[VSR_FIX_FLOW - 1], snaps[VSR_FIX_FLOW]),
           'optimizer_counts': [model.optimizer.count,
                                model.optimizer_flow.count],
           'losses': model.get_current_log(), 'fp32_tf32_off': True,
           'card': SMI}
    emit(rec)
    if not (len(clock.marks) == VSR_ITERS and math.isfinite(psnr)
            and rec['optimizer_counts'] == [VSR_ITERS] * 2
            and rec['spynet_frozen_through']
            and rec['spynet_moved_at_fix_flow']
            and all(math.isfinite(v) for v in rec['losses'].values())):
        raise AssertionError(f'basicvsr_reds train CLI: {rec}')
    emit({'phase': 'zoo_vsr_profile', **_vsr_profile(model, dopt)})
    del model
    with _StepClock((VRM,)) as clock:
        resumed = train_pipeline(root, cmd=_vsr_cmd(
            root, VSR_RESUME_ITERS, '--auto_resume'))
    n = VSR_RESUME_ITERS - VSR_ITERS
    rec = {'phase': 'zoo_vsr_auto_resume', 'from': VSR_ITERS,
           'to': VSR_RESUME_ITERS, 'iters_run': len(clock.marks),
           'optimizer_counts': [resumed.optimizer.count,
                                resumed.optimizer_flow.count],
           'steady': dict(clock.steady(2, n),
                          global_iters=[VSR_ITERS + 2, VSR_RESUME_ITERS]),
           'losses': resumed.get_current_log()}
    emit(rec)
    if not (rec['iters_run'] == n and rec['optimizer_counts'] ==
            [VSR_RESUME_ITERS] * 2 and all(
                math.isfinite(v) for v in rec['losses'].values())):
        raise AssertionError(f'basicvsr_reds --auto_resume: {rec}')


def phase_zoo_vsr():
    """Phase 17: BasicVSR card against CPU, then the train CLI on
    basicvsr_reds.yml and its --auto_resume. No kernel of the port is on
    this path (plain PyTorch, as the JAX package's XLA)."""
    _vsr_parity()
    root = os.path.join(WORK, 'reds')
    rng = np.random.default_rng(SEED + 50)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futures = (_vsr_clips(os.path.join(root, 'train'), *VSR_TRAIN, rng,
                              pool)
                   + _vsr_clips(os.path.join(root, 'val'), *VSR_VAL, rng,
                                pool))
        for f in futures:
            f.result()
    emit({'phase': 'zoo_vsr_data', 'write_s': time.perf_counter() - t0,
          'train': VSR_TRAIN, 'val': VSR_VAL})
    _vsr_cli(root)

# ---------------------------------------------------------------------------
# phase 18: K2's width gate, TIFF frames and the timing tools
# ---------------------------------------------------------------------------

# chains past K2's shared memory: the c64 net with interm_ch 320 (bf16 and
# fp32: inc split, outc on K2) and chns[0] 256 with interm_ch 320 in fp32
# (both chains of each stage split; outc's is the x2 chain, past fp32's
# 192); the fp32 checks on a reduced clip
WIDE_FP32_T, WIDE_FP32_HW = 3, (136, 240)
# each tool once at full width, few repetitions
TOOL_RUNS = (
    ('profile_blocks', ['--reps', '3']),
    ('profile_stream', ['--reps', '5', '--pushes', '20']),
    ('bench_train', ['--batch', '16', '--iters', '3', '--real-data',
                     '--synth-clips', '2', '--synth-frames', '12',
                     '--workers', '4']),
    ('bench_push_block', ['--reps', '2']),
    ('bench_stream_block_step', ['--reps', '2']),
    ('bench_block_stream', ['--reps', '2']),
    ('probe_mem', ['--reps', '3']),
    ('probe_streams', ['--pushes', '10']),
)
TIFF_T = 11


def _k2_limits():
    """conv_chain.fits against the kernel at each limit: the widest
    intermediate launches, 64 channels more is refused (not counted)."""
    x = torch.zeros((1, 8, 30, 16), device='cuda')
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for has_x2 in (False, True):
            widest = max(c for c in range(64, 513, 64)
                         if conv_chain_mod.fits(c, dtype, has_x2))
            ok = {}
            for c1 in (widest, widest + 64):
                w1 = torch.zeros((c1, 16, 3, 3), device='cuda')
                w2 = torch.zeros((64, c1, 3, 3), device='cuda')
                v = x.to(dtype)
                before = conv_chain.launches
                try:
                    if has_x2:
                        conv_chain_add2_res(v, v, v, w1, None, w2, None,
                                            res_ch=3)
                    else:
                        conv_chain(v, w1, None, w2, None)
                    torch.cuda.synchronize()
                    ok[c1] = conv_chain.launches == before + 1
                except RuntimeError as e:
                    if 'CUDA error' not in str(e):
                        raise
                    ok[c1] = False
            if ok != {widest: True, widest + 64: False}:
                raise AssertionError(f'K2 at {dtype}, x2 {has_x2}: fits '
                                     f'says {widest}, the kernel {ok}')
            out[f'{str(dtype)[6:]}{"_x2" if has_x2 else ""}'] = widest
    return out


def _wide_forward(cfg_over, dtype, t_len, hw, seed, device):
    """A forward of the c64 net changed by ``cfg_over`` through the
    kernels, its launches, and its input and fp32 weights."""
    from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                                wnet_init)
    base = dict(chns=tuple(C64['chns']), mid_ch=C64['mid_ch'],
                interm_ch=C64['interm_ch'], norm='none', act=C64['act'])
    cfg = WNetConfig(**dict(base, **cfg_over))
    raw = prepare_params(wnet_init(cfg, seed=seed), device, torch.float32)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((1, t_len, *hw, 4), generator=g, device=device)
    reset_counts()
    with torch.no_grad(), _no_conv2d_on(device):
        y = wnet_apply(prepare_params(raw, device, dtype), x.to(dtype), cfg)
    _sync(device)
    return cfg, raw, x, y, counts()


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _no_conv2d_on(device):
    """F.conv2d refused on the card's kernel path (on the CPU the ops'
    plain versions call it)."""
    import contextlib
    return (_NoConv2d() if torch.device(device).type == 'cuda'
            else contextlib.nullcontext())


def _wide_chains(device='cuda', full=(T, (H, W)),
                 small=(WIDE_FP32_T, WIDE_FP32_HW)):
    """The split route at full width (bf16, interm_ch 320) and the fp32
    split sites against the plain route (on ``small`` clips); returns the
    records and the launches (on the CPU the ops run their plain versions
    and launch nothing: a rehearsal)."""
    from bsvd_tpu_torch.archs.wnet_arch import prepare_params
    from bsvd_tpu_torch.tools import _common as tc
    launches = dict.fromkeys(KERNELS, 0)
    recs = []
    on_card = torch.device(device).type == 'cuda'
    for name, over, dtype, (t_len, hw), k2 in (
            ('bf16_interm320', {'interm_ch': 320}, torch.bfloat16, full, 2),
            ('fp32_interm320', {'interm_ch': 320}, torch.float32, small, 2),
            ('fp32_c256_interm320', {'interm_ch': 320,
                                     'chns': (256, 128, 256)},
             torch.float32, small, 0)):
        cfg, raw, x, y, n = _wide_forward(over, dtype, t_len, hw, SEED + 18,
                                          device)
        want = dict(PER_FORWARD, conv_chain=k2,
                    conv3x3=PER_FORWARD['conv3x3'] + 2 * (4 - k2))
        for k in KERNELS:
            if on_card and n[k] != want.get(k, 0):
                raise AssertionError(f'{name}: {k} launched {n[k]}, '
                                     f'expected {want.get(k, 0)}')
            launches[k] += n[k]
        with torch.no_grad(), tc.plain_route():
            ref = wnet_apply(raw, x, cfg)
            if dtype == torch.bfloat16:
                plain = wnet_apply(prepare_params(raw, device, dtype),
                                   x.to(dtype), cfg)
        if dtype == torch.float32:
            err, _ = rel_err(y, ref)
            tol = FP32_TOL * ref.abs().max().item()
            if not err <= tol:
                raise AssertionError(f'{name}: max|diff| {err} > {tol}')
            check = {'max_abs_err': err, 'tol': tol}
        else:
            # phase 4's rule: the kernels' bf16 output no more than 1 dB
            # below the plain bf16 route's, both against the plain fp32
            p_k, p_plain = psnr(y, ref), psnr(plain, ref)
            if not p_k >= p_plain - 1:
                raise AssertionError(f'{name}: {p_k} dB against fp32, the '
                                     f'plain bf16 route {p_plain}')
            p = prepare_params(raw, device, dtype)
            xb = x.to(dtype)
            with torch.no_grad():
                ms = (median_ms(lambda: wnet_apply(p, xb, cfg), reps=5)
                      if on_card else None)
            check = {'psnr_vs_fp32_plain_db': p_k,
                     'plain_bf16_psnr_db': p_plain, 'forward_ms': ms}
            del plain, p, xb
        recs.append({'net': name, 'interm_ch': cfg.interm_ch,
                     'chns': list(cfg.chns), 'frames': t_len, 'hw': list(hw),
                     'launches': {k: v for k, v in n.items() if v},
                     'k2_at_split_sites': 0, **check})
        del y, ref
    return recs, launches


def _tiff_rates():
    """ms to decode a 540x960 frame as TIFF (LZW + predictor 2, Deflate +
    predictor 2, none: the port's writer, cv2's defaults) beside PNG's,
    the same frame; each read back equal to it."""
    from bsvd_tpu_torch.utils import img_util
    clean = _clips(np.random.default_rng(SEED + 19), 1, 1)[0][0][0]
    rgb = np.round(clean.transpose(1, 2, 0) * 255).astype(np.uint8)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    folder = os.path.join(WORK, 'tiff_rates')
    os.makedirs(folder, exist_ok=True)
    out = {}
    for name, ext, params, load in (
            ('tiff_lzw_predictor', 'tif', [5], tiff_decode.load),
            ('tiff_deflate_predictor', 'tif', [8], tiff_decode.load),
            ('tiff_none', 'tif', [1], tiff_decode.load),
            ('png', 'png', None, png_decode.load)):
        path = os.path.join(folder, f'{name}.{ext}')
        t0 = time.perf_counter()
        img_util.imwrite(bgr, path, None if params is None else
                         [img_util.IMWRITE_TIFF_COMPRESSION, params[0]])
        write_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(load(path), rgb):
            raise AssertionError(f'{name}: read back differs')
        out[name] = {'ms_per_frame': _median_ms(lambda: load(path), 10),
                     'write_ms': write_ms, 'bytes': os.path.getsize(path)}
    path = os.path.join(folder, 'tiff_lzw_predictor.tif')
    win = min(TRAIN_HW, H // 2, W // 2)
    out['tiff_lzw_window_96_ms'] = _median_ms(
        lambda: tiff_decode.load_crop(path, H // 3, W // 3, win, win), 10)
    return out


def _run_tool(name, argv, device='cuda'):
    """``bsvd_tpu_torch.tools.<name>.main(argv)`` in this process; its
    stdout's last line parsed as JSON (and equal to what main returns)."""
    import importlib
    import io
    from contextlib import redirect_stdout
    mod = importlib.import_module(f'bsvd_tpu_torch.tools.{name}')
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rec = mod.main(list(argv))
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if json.loads(lines[-1]) != json.loads(json.dumps(rec)):
        raise AssertionError(f'{name}: its JSON line is not its record')
    if rec['tool'] != name or rec['device'] != device:
        raise AssertionError(f'{name}: {rec["tool"]} on {rec["device"]}')
    return rec, seconds


def _tool_summary(name, rec):
    """The numbers PERF.md keeps of a tool's record (the whole record is
    printed as the tool's own line before)."""
    sites = [k for k in ('blocks', 'sites') if isinstance(rec.get(k), list)]
    keep = {k: v for k, v in rec.items()
            if k not in sites + ['device', 'device_name']}
    for key in sites:
        keep[key] = {s['site']: {k: s[k] for k in (
            'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
            'max_abs_err_fp32', 'tol_fp32', 'max_abs_err_bf16', 'tol_bf16')}
            for s in rec[key]}
    return keep


def phase_tools(device='cuda', tool_args=(), burnin_args=(), wide=None):
    """Phase 18. Returns the launches of this slice's main paths: the wide
    chains' forwards and test_pipeline on the .tif folder. On the CPU (a
    rehearsal at the sizes ``tool_args`` / ``burnin_args`` / ``wide``
    give) the launch and K2-limit checks are left out."""
    on_card = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    limits = _k2_limits() if on_card else None
    wide, launches = _wide_chains(device, **(wide or {}))
    emit({'phase': 'k2_route', 'widest_k2_intermediate': limits,
          'nets': wide, 'smi': SMI})
    emit({'phase': 'tiff_frames', 'hw': [H, W], 'smi': SMI,
          'decode': _tiff_rates()})
    # test_pipeline on a 25-frame 540x960 .tif folder (the Set8 family of
    # the burn-in tool), the slice's main path: counted
    burnin = ['--root', os.path.join(WORK, 'burnin'), '--device', device,
              *burnin_args]
    routes = dict(utils_common.ROUTES)
    reset_counts()
    with _no_conv2d_on(device):
        rec, secs = _run_tool('run_eval_burnin', burnin + [
            '--only', 'set8', '--set8-clips', '1', '--frames', str(TIFF_T),
            '--sigmas', '20', '--format', 'tif'], device)
    n = counts()
    for k in KERNELS:
        want = PER_FORWARD.get(k, 0)
        if on_card and n[k] != want:
            raise AssertionError(f'tif test_pipeline: {k} launched {n[k]}, '
                                 f'expected {want}')
        launches[k] += n[k]
    if _routes_since(routes) != {'tiff_decode': TIFF_T}:
        raise AssertionError(f'tif frames read by {_routes_since(routes)}')
    if not all(math.isfinite(v) for m in rec['results'].values()
               for v in m.values()):
        raise AssertionError('tif test_pipeline: a metric is not finite')
    tools = {'run_eval_burnin_set8_tif': dict(_tool_summary(
        'run_eval_burnin', rec), seconds=secs)}
    rec, secs = _run_tool('run_eval_burnin', burnin + [
        '--only', 'davis', '--davis-clips', '1', '--frames', '10',
        '--sigmas', '30'], device)
    tools['run_eval_burnin_davis_png'] = dict(
        _tool_summary('run_eval_burnin', rec), seconds=secs)
    for name, argv in TOOL_RUNS:
        rec, secs = _run_tool(name, list(argv) + ['--device', device,
                                                  *tool_args], device)
        tools[name] = dict(_tool_summary(name, rec), seconds=secs)
    emit({'phase': 'tools', 'smi': SMI, 'tools': tools,
          'seconds': time.perf_counter() - t0})
    return launches

# ---------------------------------------------------------------------------
# phase 19: the zoo's face GANs (HiFaceGAN, StyleGAN2) and the inference
# scripts
# ---------------------------------------------------------------------------

HIFACEGAN_YML = os.path.join(ROOT, 'options', 'train', 'hifacegan_sr4x.yml')
FACE_ITERS, SG_ITERS = 20, 16
# 8 GT faces at the yml's gt_size 512 (LQ: prepare_hifacegan_dataset's sr4x
# template, the ported script) and 16 FFHQ-sized 256 x 256 faces for
# StyleGAN2
FACE_N, FACE_HW, SG_N, SG_HW = 8, 512, 16, 256
# BasicSR's options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ.yml: its
# nets, losses, lazy-regularisation intervals, mixing, Adam and data
# normalisation; the folder (the port reads no lmdb), the batch (4 on one
# card) and the iteration count are this phase's
SG_YML = """name: stylegan2_256_cmul2_ffhq
model_type: StyleGAN2Model
num_gpu: auto
manual_seed: 2021
datasets:
  train:
    name: FFHQ
    type: FFHQDataset
    dataroot_gt: {data}
    io_backend:
      type: disk
    use_hflip: true
    mean: [0.5, 0.5, 0.5]
    std: [0.5, 0.5, 0.5]
    num_worker_per_gpu: 3
    batch_size_per_gpu: 4
    dataset_enlarge_ratio: 100
network_g:
  type: StyleGAN2Generator
  out_size: 256
  num_style_feat: 512
  num_mlp: 8
  channel_multiplier: 2
  resample_kernel: [1, 3, 3, 1]
  lr_mlp: 0.01
network_d:
  type: StyleGAN2Discriminator
  out_size: 256
  channel_multiplier: 2
  resample_kernel: [1, 3, 3, 1]
path:
  pretrain_network_g: ~
  strict_load_g: true
  resume_state: ~
train:
  optim_g:
    type: Adam
    lr: !!float 2e-3
  optim_d:
    type: Adam
    lr: !!float 2e-3
  scheduler:
    type: MultiStepLR
    milestones: [600000]
    gamma: 0.5
  total_iter: {iters}
  warmup_iter: -1
  gan_opt:
    type: GANLoss
    gan_type: wgan_softplus
    loss_weight: !!float 1
  r1_reg_weight: 10
  path_batch_shrink: 2
  path_reg_weight: 2
  net_g_reg_every: 4
  net_d_reg_every: 16
  mixing_prob: 0.9
  net_d_iters: 1
  net_d_init_iters: 0
logger:
  print_freq: 100
  save_checkpoint_freq: !!float 5e3
  use_tb_logger: false
"""


def _faces(n, hw, rng):
    """n uint8 (hw, hw, 3) images: a smooth random field (a 16x-coarser
    grid, bilinear) under a bright ellipse, with pixel noise; made on the
    card."""
    gen = torch.Generator('cuda').manual_seed(int(rng.integers(1 << 31)))
    base = torch.rand((n, 3, hw // 16 + 2, hw // 16 + 2), generator=gen,
                      device='cuda') * 255
    field = F.interpolate(base, size=(hw, hw), mode='bilinear',
                          align_corners=False)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, hw, device='cuda'),
                            torch.linspace(-1, 1, hw, device='cuda'),
                            indexing='ij')
    face = ((xx / 0.6) ** 2 + (yy / 0.8) ** 2 < 1).float() * 60
    img = field + face + torch.randn(field.shape, generator=gen,
                                     device='cuda') * 6
    return img.clamp(0, 255).round()


def _write_faces(folder, imgs, pool):
    """Futures of the PNG writes of (n, 3, h, w) float [0, 255] RGB."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    arr = imgs.permute(0, 2, 3, 1).flip(-1).to(torch.uint8).cpu().numpy()
    return [pool.submit(imwrite, np.ascontiguousarray(a),
                        os.path.join(folder, f'{i:05d}.png'))
            for i, a in enumerate(arr)]


def _sr4x_lq(gt, rng):
    """HiFaceGAN's LQ of (n, 3, h, w) float RGB GT faces by the ported
    prepare_hifacegan_dataset's sr4x template (4x INTER_AREA down, INTER_CUBIC
    up, on the card), as (n, 3, h, w) float RGB."""
    from bsvd_tpu_torch.scripts.data_preparation.prepare_hifacegan_dataset \
        import degrade
    bgr = gt.permute(0, 2, 3, 1).flip(-1).to(torch.uint8)
    lq = torch.stack([degrade(b, 'sr4x', rng, 'cuda') for b in bgr])
    return lq.flip(-1).permute(0, 3, 1, 2).float()


def _face_data(root, rng):
    """root/gt, root/lq (HiFaceGAN) and root/ffhq (StyleGAN2)."""
    gt = _faces(FACE_N, FACE_HW, rng)
    lq = _sr4x_lq(gt, np.random.default_rng(SEED + 62))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        for f in (_write_faces(os.path.join(root, 'gt'), gt, pool)
                  + _write_faces(os.path.join(root, 'lq'), lq, pool)
                  + _write_faces(os.path.join(root, 'ffhq'),
                                 _faces(SG_N, SG_HW, rng), pool)):
            f.result()
    return time.perf_counter() - t0


class _StoredNoise(torch.nn.Module):
    """A StyleGAN2 generator on two styles with its stored noise."""

    def __init__(self, g):
        super().__init__()
        self.g = g

    def forward(self, s1, s2):
        return self.g([s1, s2], randomize_noise=False)[0]


def _card_matches_cpu(out, name, net, *args):
    """``net`` (on the CPU) and a copy of it on the card on the same
    inputs, fp32: appends the record to ``out``, raises past 1e-4 x
    max|ref| or on a value that is not finite; returns the CPU's
    output."""
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = net(*args)
        cpu_s = time.perf_counter() - t0
        got = copy.deepcopy(net).to('cuda')(*[a.cuda() for a in args]).cpu()
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    out.append({'net': name, 'shape_out': list(ref.shape),
                'max_abs_err': err, 'max_abs_ref': scale, 'cpu_s': cpu_s})
    if not err <= FP32_TOL * scale or not torch.isfinite(got).all():
        raise AssertionError(f'{name} card vs CPU: {out[-1]}')
    return ref


def _face_parity():
    """Card (fp32, TF32 off) against CPU on the same weights, to 1e-4 x
    max|ref|: HiFaceGAN at num_feat 48 on a 64 x 64 LQ, StyleGAN2's 256
    Cmul2 generator (stored noise, two styles) and its discriminator on
    the generator's image."""
    rng = np.random.default_rng(SEED + 60)
    out = []

    def check(name, net, *args):
        return _card_matches_cpu(out, name, net, *args)
    lq = torch.from_numpy(rng.uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32))
    check('HiFaceGAN num_feat 48', build_network(
        {'type': 'HiFaceGAN', 'num_feat': 48, 'is_train': False,
         'seed': SEED}, 'cpu').eval(), lq)
    z = [torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32))
         for _ in range(2)]
    img = check('StyleGAN2Generator 256 Cmul2', _StoredNoise(build_network(
        {'type': 'StyleGAN2Generator', 'out_size': SG_HW, 'seed': SEED},
        'cpu')), *z)
    check('StyleGAN2Discriminator 256 Cmul2', build_network(
        {'type': 'StyleGAN2Discriminator', 'out_size': SG_HW,
         'seed': SEED}, 'cpu'), img)
    emit({'phase': 'face_parity', 'nets': out,
          'tol': f'{FP32_TOL} x max|ref|', 'fp32_tf32_off': True})


def _hifacegan_cli(root):
    """The train CLI on hifacegan_sr4x.yml at its widths (num_feat 48,
    gt_size 512, batch 1, VGG19 perceptual at random weights), --force_yml
    changing the folders and total_iter only: FACE_ITERS iterations and
    the run's one validation (the yml's val_freq is past them)."""
    from bsvd_tpu_torch.models.hifacegan_model import HiFaceGANModel as HF
    from bsvd_tpu_torch.models.sr_model import SRModel
    u0, vals = {}, []
    step, validation = HF.optimize_parameters, SRModel.validation

    def watched(model, it):
        if it == 1:
            u0.update({k: v.clone() for k, v in
                       model.net_d.state_dict().items()
                       if k.endswith('weight_u')})
        step(model, it)

    def timed_validation(model, *a, **k):
        t0 = time.perf_counter()
        res = validation(model, *a, **k)
        torch.cuda.synchronize()
        vals.append((res, time.perf_counter() - t0))
        return res
    cmd = ['-opt', HIFACEGAN_YML, '--force_yml',
           *(f'datasets:{ph}:dataroot_{k}={root}/{k}'
             for ph in ('train', 'val') for k in ('gt', 'lq')),
           f'train:total_iter={FACE_ITERS}']
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    HF.optimize_parameters, SRModel.validation = watched, timed_validation
    try:
        t0 = time.perf_counter()
        with _StepClock((SRModel, HF)) as clock:
            model = train_pipeline(root, cmd=cmd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        HF.optimize_parameters, SRModel.validation = step, validation
    peak = torch.cuda.max_memory_allocated() / 1e9
    u1 = {k: v for k, v in model.net_d.state_dict().items()
          if k.endswith('weight_u')}
    steady = clock.steady(11, FACE_ITERS)
    opt, dopt = model.opt, model.opt['datasets']['train']
    exp = os.path.join(root, 'experiments', opt['name'], 'models')
    rec = {'phase': 'face_hifacegan_cli',
           'yml': os.path.relpath(HIFACEGAN_YML, ROOT),
           'model': type(model).__name__, 'network_g': opt['network_g'],
           'network_d': opt['network_d'], 'iters': FACE_ITERS,
           'batch': dopt['batch_size_per_gpu'], 'gt_size': dopt['gt_size'],
           'params_g': count_params(model.net),
           'params_d': count_params(model.net_d),
           'vgg19_pretrained': model.cri_perceptual.vgg.pretrained,
           'wall_s': wall, 'steady': steady,
           'wait_share': steady['data_wait_ms'] / steady['ms_per_iter'],
           'peak_allocated_gb': peak, 'losses': model.get_current_log(),
           'optimizer_counts': [model.optimizer.count,
                                model.optimizer_d.count],
           'u_vectors': len(u1),
           'u_moved': sum(not torch.equal(u0[k], v) for k, v in u1.items()),
           'validations': len(vals),
           'val_psnr': vals[0][0]['psnr'] if vals else None,
           'val_s': vals[0][1] if vals else None,
           'val_images': FACE_N,
           'checkpoints': sorted(os.listdir(exp)), 'fp32_tf32_off': True,
           'card': SMI}
    emit(rec)
    if not (len(clock.marks) == FACE_ITERS and len(vals) == 1
            and math.isfinite(rec['val_psnr'])
            and rec['optimizer_counts'] == [FACE_ITERS] * 2
            and rec['u_vectors'] == 10 and rec['u_moved'] == 10
            and {'net_g_latest.npz', 'net_d_latest.npz'}
            <= set(rec['checkpoints'])
            and all(math.isfinite(v) for v in rec['losses'].values())):
        raise AssertionError(f'hifacegan_sr4x train CLI: {rec}')


def _stylegan2_cli(root):
    """The train CLI on SG_YML (BasicSR's 256 Cmul2 FFHQ widths) for
    SG_ITERS iterations: r1 at 16 (with the path penalty, every 4
    iterations); each iteration clocked between two synchronizations."""
    from bsvd_tpu_torch.models.stylegan2_model import StyleGAN2Model as SG
    yml = os.path.join(root, 'train_StyleGAN2_256_Cmul2_FFHQ.yml')
    with open(yml, 'w') as f:
        f.write(SG_YML.format(data=os.path.join(root, 'ffhq'),
                              iters=SG_ITERS))
    ms, step = {}, SG.optimize_parameters

    def timed(model, it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, it)
        torch.cuda.synchronize()
        ms[it] = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    SG.optimize_parameters = timed
    try:
        t0 = time.perf_counter()
        model = train_pipeline(root, cmd=['-opt', yml])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        SG.optimize_parameters = step
    peak = torch.cuda.max_memory_allocated() / 1e9
    kinds = {'plain': [i for i in ms if i % 4 and i > 4],
             'path': [i for i in ms if i % 4 == 0 and i % 16 and i > 4],
             'r1_and_path': [i for i in ms if i % 16 == 0]}
    opt = model.opt
    exp = os.path.join(root, 'experiments', opt['name'], 'models')
    rec = {'phase': 'face_stylegan2_cli',
           'source': 'BasicSR options/train/StyleGAN/'
                     'train_StyleGAN2_256_Cmul2_FFHQ.yml (widths, losses, '
                     'regularisation; folder, batch 4 and iterations here)',
           'network_g': opt['network_g'], 'network_d': opt['network_d'],
           'iters': SG_ITERS,
           'batch': opt['datasets']['train']['batch_size_per_gpu'],
           'params_g': count_params(model.net),
           'params_d': count_params(model.net_d), 'wall_s': wall,
           'ms_per_iter': {k: statistics.median(ms[i] for i in v)
                           for k, v in kinds.items()},
           'iters_by_kind': kinds, 'first_iter_ms': ms[1],
           'peak_allocated_gb': peak, 'losses': model.get_current_log(),
           'mean_path_length': float(model.mean_path_length),
           'optimizer_counts': [model.optimizer.count,
                                model.optimizer_d.count],
           'checkpoints': sorted(os.listdir(exp)), 'fp32_tf32_off': True,
           'card': SMI}
    emit(rec)
    log = rec['losses']
    if not (len(ms) == SG_ITERS and rec['optimizer_counts'] == [SG_ITERS] * 2
            and log['l_d_r1'] > 0 and log['l_g_path'] > 0
            and rec['mean_path_length'] > 0
            and 'net_g_latest.npz' in rec['checkpoints']
            and all(math.isfinite(v) for v in log.values())):
        raise AssertionError(f'StyleGAN2 256 Cmul2 train CLI: {rec}')
    # where an iteration's time goes, by kind: one more iteration of each
    # on the CLI's model and last batch, under the profiler
    prof = {}
    for kind, it in (('plain', SG_ITERS + 1), ('path', SG_ITERS + 4),
                     ('r1_and_path', SG_ITERS + 16)):
        def run(it=it):
            model.optimize_parameters(it)
            torch.cuda.synchronize()
        prof[kind] = device_profile(run, 1, f'stylegan2_{kind}')
        prof[kind].pop('by_kernel')
        prof[kind]['top_device_ms_per_unit'] = \
            prof[kind]['top_device_ms_per_unit'][:8]
    emit({'phase': 'face_stylegan2_profile', 'iterations': prof,
          'card': SMI})


def _inference_scripts(root, rng):
    """The three inference modules by their ``main(argv)`` in this process:
    StyleGAN2 at --size 1024 --sample 4 on a checkpoint of random weights
    saved here, ESRGAN (x4) and RIDNet on two synthetic PNGs each."""
    from bsvd_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
    from bsvd_tpu_torch.convert.torch_generic import to_jax_tree
    from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite

    def read(path):
        with open(path, 'rb') as f:
            return imfrombytes(f.read(), 'color')
    ckpts = {'stylegan2': os.path.join(root, 'stylegan2_1024.npz'),
             'esrgan': os.path.join(root, 'rrdbnet_x4.npz'),
             'ridnet': os.path.join(root, 'ridnet.npz')}
    save_npz_params(ckpts['stylegan2'], {'params_ema': to_jax_tree(
        StyleGAN2Generator(1024, seed=SEED))})
    save_npz_params(ckpts['esrgan'], {'params': to_jax_tree(build_network(
        {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 64,
         'num_block': 23, 'scale': 4, 'seed': SEED}, 'cpu'))})
    save_npz_params(ckpts['ridnet'], {'params': to_jax_tree(build_network(
        {'type': 'RIDNet', 'in_channels': 3, 'mid_channels': 64,
         'out_channels': 3, 'seed': SEED}, 'cpu'))})
    for i, hw in enumerate((128, 200)):
        img = rng.integers(0, 256, (hw, hw + 24, 3)).astype(np.uint8)
        imwrite(img, os.path.join(root, 'inputs', f'{i:02d}.png'))
    runs = {
        'inference_stylegan2': ['--ckpt', ckpts['stylegan2'], '--size',
                                '1024', '--sample', '4', '--output',
                                os.path.join(root, 'samples')],
        'inference_esrgan': ['--model_path', ckpts['esrgan'], '--input',
                             os.path.join(root, 'inputs'), '--output',
                             os.path.join(root, 'esrgan')],
        'inference_ridnet': ['--model_path', ckpts['ridnet'], '--test_path',
                             os.path.join(root, 'inputs'), '--output',
                             os.path.join(root, 'ridnet')]}
    rec = {'phase': 'face_inference', 'card': SMI, 'in_process': True}
    for name, argv in runs.items():
        seconds = _run_main(f'bsvd_tpu_torch.inference.{name}', argv)
        folder = argv[argv.index('--output') + 1]
        rec[name] = {'main_s': seconds,
                     'outputs': {f: list(read(os.path.join(folder, f)).shape)
                                 for f in sorted(os.listdir(folder))}}
    want = {'inference_stylegan2': {'000000.png': [2048, 2048, 3]},
            'inference_esrgan': {'00_ESRGAN.png': [512, 608, 3],
                                 '01_ESRGAN.png': [800, 896, 3]},
            'inference_ridnet': {'00_RIDNet.png': [128, 152, 3],
                                 '01_RIDNet.png': [200, 224, 3]}}
    emit(rec)
    for name, outs in want.items():
        if rec[name]['outputs'] != outs:
            raise AssertionError(f'{name}: {rec[name]} (expected {outs})')
    grid = read(os.path.join(root, 'samples', '000000.png'))
    if not grid.std() > 0:
        raise AssertionError('inference_stylegan2: a constant image')


def phase_face_gans():
    """Phase 19: the zoo's face GANs from the command line and the
    inference scripts. No kernel of the port is on these paths (plain
    PyTorch, as the JAX package's XLA): the kernels line is unchanged."""
    t0 = time.perf_counter()
    root = os.path.join(WORK, 'faces')
    rng = np.random.default_rng(SEED + 61)
    _face_parity()
    emit({'phase': 'face_data', 'write_s': _face_data(root, rng),
          'hifacegan': [FACE_N, FACE_HW, FACE_HW],
          'ffhq': [SG_N, SG_HW, SG_HW]})
    _hifacegan_cli(root)
    _stylegan2_cli(root)
    _inference_scripts(root, rng)
    emit({'phase': 'face_gans', 'seconds': time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 20: the rest of the zoo's video family (EDVR-M from the command
# line, IconVSR, TOFlow, DUF, the video GAN engines, inference_basicvsr)
# ---------------------------------------------------------------------------

# BasicSR's options/train/EDVR/train_EDVR_M_x4_SR_REDS_M.yml: its nets,
# data, schedule, loss and metric (num_gpu auto: one card here, BasicSR's
# 8); EDVR_FORCE changes the folders (and lmdb to disk), drops the
# pretrained file and cuts total_iter and tsa_iter
EDVR_YML = """name: 100_EDVR_M_x4_SR_REDS_600k_B4G8_valREDS4
model_type: EDVRModel
scale: 4
num_gpu: auto
manual_seed: 10
datasets:
  train:
    name: REDS
    type: REDSDataset
    dataroot_gt: datasets/REDS/train_sharp_with_val.lmdb
    dataroot_lq: datasets/REDS/train_sharp_bicubic_with_val.lmdb
    dataroot_flow: ~
    meta_info_file: basicsr/data/meta_info/meta_info_REDS_GT.txt
    val_partition: REDS4
    io_backend:
      type: lmdb
    num_frame: 5
    gt_size: 256
    interval_list: [1]
    random_reverse: false
    use_hflip: true
    use_rot: true
    num_worker_per_gpu: 3
    batch_size_per_gpu: 4
    dataset_enlarge_ratio: 200
    prefetch_mode: ~
  val:
    name: REDS4
    type: VideoTestDataset
    dataroot_gt: datasets/REDS/train_sharp
    dataroot_lq: datasets/REDS/train_sharp_bicubic
    meta_info_file: basicsr/data/meta_info/meta_info_REDS4_test_GT.txt
    io_backend:
      type: disk
    cache_data: false
    num_frame: 5
    padding: reflection_circle
network_g:
  type: EDVR
  num_in_ch: 3
  num_out_ch: 3
  num_feat: 64
  num_frame: 5
  deformable_groups: 8
  num_extract_block: 5
  num_reconstruct_block: 10
  center_frame_idx: ~
  hr_in: false
  with_predeblur: false
  with_tsa: true
path:
  pretrain_network_g: experiments/pretrained_models/EDVR/EDVR_M_woTSA_x4_SR_REDS_official-1edf645c.pth
  strict_load_g: false
  resume_state: ~
train:
  optim_g:
    type: Adam
    lr: !!float 4e-4
    weight_decay: 0
    betas: [0.9, 0.99]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [50000, 100000, 150000, 150000, 150000]
    restart_weights: [1, 0.5, 0.5, 0.5, 0.5]
    eta_min: !!float 1e-7
  total_iter: 600000
  warmup_iter: -1
  tsa_iter: 50000
  dcn_lr_mul: 1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: sum
val:
  val_freq: !!float 5e3
  save_img: false
  metrics:
    psnr:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: false
logger:
  print_freq: 100
  save_checkpoint_freq: !!float 5e3
  use_tb_logger: true
  wandb:
    project: ~
    resume_id: ~
dist_params:
  backend: nccl
  port: 29500
"""
EDVR_ITERS, EDVR_TSA_ITER = 20, 11
# REDS's 720 x 1280 GT / 180 x 320 LQ frames: (clips, frames) of the train
# and val trees
EDVR_TRAIN, EDVR_VAL = (2, 10), (1, 5)
EDVR_M = {'type': 'EDVR', 'num_feat': 64, 'num_frame': 5,
          'deformable_groups': 8, 'num_extract_block': 5,
          'num_reconstruct_block': 10, 'with_tsa': True}
ICON_NET = {'type': 'IconVSR', 'num_feat': 64, 'num_block': 30,
            'keyframe_stride': 5, 'temporal_padding': 2}
# the steps' gradients, card against CPU (both fp32): each optimizer
# group's L2 difference within this share of its L2 norm. fp32 alone
# parts them by 1e-3 - 1e-2, differing from run to run on the same
# inputs (H100 80GB HBM3, 700 W: EDVR-M as G of the GAN step 1.2e-3 -
# 1.0e-2 over five runs; its D up to 5.5e-3; IconVSR's SpyNet group
# 1.5e-3): the card's scatter-adds sum in no fixed order, and a bilinear
# sample's gradient in its coordinate jumps where the coordinate crosses
# a pixel. A fault on the card moved G's by 11.5% (the channels-last
# average-pool backward, ROADMAP Queue 3).
STEP_GRAD_TOL = 5e-2


def _random_offsets(net, seed, scale=2.0):
    """Every DCN pack's conv_offset random (a fresh pack's is zero, a
    plain conv): offsets of a few pixels."""
    from bsvd_tpu_torch.ops.deform_conv import DCNv2Pack
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, DCNv2Pack):
                w = m.conv_offset.weight
                w.copy_((torch.randn(w.shape, generator=gen) * scale
                         / w[0].numel() ** 0.5).to(w.device))
                m.conv_offset.bias.copy_(torch.randn(
                    m.conv_offset.bias.shape, generator=gen).to(w.device))
    return net


def _video_parity():
    """Card (fp32, TF32 off) against CPU on the same weights, to 1e-4 x
    max|ref|: EDVR-M (random DCN offsets) on 5 frames of 64 x 64, IconVSR
    (64 x 30, key frames every 5, temporal padding 2) on a 15-frame
    64 x 64 clip, TOFlow on 7 frames and DUF x4 (52 layers) on 7 frames of
    64 x 64."""
    rng = np.random.default_rng(SEED + 70)
    out = []

    def check(name, net, x):
        _card_matches_cpu(out, name, net.eval(), x)
        out[-1].update(shape_in=list(x.shape), params=count_params(net))

    def clip(t):
        return torch.from_numpy(rng.uniform(0, 1, (1, t, 3, 64, 64)).astype(
            np.float32))
    check('EDVR-M', _random_offsets(build_network(
        dict(EDVR_M, seed=SEED), 'cpu'), SEED + 71), clip(5))
    check('IconVSR 64 x 30', _random_offsets(build_network(
        dict(ICON_NET, seed=SEED), 'cpu'), SEED + 72), clip(15))
    check('TOFlow', build_network({'type': 'TOFlow', 'seed': SEED}, 'cpu'),
          clip(7))
    check('DUF x4 52 layers', build_network(
        {'type': 'DUF', 'scale': 4, 'num_layer': 52, 'seed': SEED}, 'cpu'),
        clip(7))
    emit({'phase': 'video_parity', 'nets': out,
          'tol': f'{FP32_TOL} x max|ref|', 'fp32_tf32_off': True})


def _capture_grads(optim, into):
    """Wrap ``optim.step`` to keep, in ``into``, each step's gradients (on
    the CPU) before it runs."""
    step = optim.step

    def capture():
        into.update({n: (torch.zeros_like(p) if p.grad is None
                         else p.grad).detach().cpu().clone()
                     for n, p in zip(optim.names, optim.params)})
        step()
    optim.step = capture


def _steps_card_vs_cpu(opt, batch, iters, nets, seed):
    """``iters`` steps of the model of ``opt`` on the card and on the CPU
    (fp32), each from the card's weights (loaded into the CPU's model
    before the step; ``nets`` names the model's networks): every step's
    logged losses within 1e-4 x max(1, |ref|), and each optimizer group's
    gradients within STEP_GRAD_TOL in L2. Returns the record."""
    from bsvd_tpu_torch.models.base_model import build_model
    models = [build_model(copy.deepcopy(opt), device=d)
              for d in ('cuda', 'cpu')]
    for m in models:
        for name in nets:
            _random_offsets(getattr(m, name), seed)
    grads = [{} for _ in models]
    for m, into in zip(models, grads):
        for attr in ('optimizer', 'optimizer_d', 'optimizer_flow',
                     'optimizer_dcn'):
            optim = getattr(m, attr, None)
            if optim is not None:
                into[attr] = {}
                _capture_grads(optim, into[attr])
    card, cpu = models
    rec = {'steps': [], 'ms_per_step_card': []}
    for it in range(1, iters + 1):
        for name in nets:
            getattr(cpu, name).load_state_dict(
                {k: v.cpu() for k, v in getattr(card, name).state_dict()
                 .items()})
        for m in models:
            m.feed_data(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.optimize_parameters(it)
        torch.cuda.synchronize()
        rec['ms_per_step_card'].append((time.perf_counter() - t0) * 1e3)
        cpu.optimize_parameters(it)
        got, ref = card.get_current_log(), cpu.get_current_log()
        step = {'it': it, 'losses': got, 'loss_errs': {
            k: abs(got[k] - ref[k]) / max(1.0, abs(ref[k])) for k in ref}}
        for attr in grads[1]:
            want, have = grads[1][attr], grads[0][attr]
            d = {n: (have[n] - g).double() for n, g in want.items()}
            norm = math.sqrt(sum(float(g.double().square().sum())
                                 for g in want.values()))
            worst = max(d, key=lambda n: float(d[n].abs().max()))
            scale = max(float(g.abs().max()) for g in want.values())
            step[attr] = {
                'l2_over_l2': math.sqrt(sum(float(v.square().sum())
                                            for v in d.values()))
                / max(norm, 1e-30),
                'max_over_max': float(d[worst].abs().max())
                / max(scale, 1e-30), 'worst_tensor': worst}
        rec['steps'].append(step)
        if not (list(got) == list(ref)
                and all(math.isfinite(v) for v in got.values())
                and max(step['loss_errs'].values()) <= FP32_TOL
                and all(step[a]['l2_over_l2'] <= STEP_GRAD_TOL
                        for a in grads[1])):
            raise AssertionError(f'{opt["model_type"]} steps card vs CPU: '
                                 f'{rec}')
    rec['optimizer_counts'] = {a: getattr(card, a).count for a in grads[0]}
    return rec


def _video_steps(root):
    """3 VideoRecurrentModel steps of IconVSR (64 x 30) on a 5-frame 32 x
    32 clip (SpyNet frozen at step 1, fix_flow 2) and 3 VideoGANModel
    steps with EDVR-M as G and the VGG-style discriminator (128, 64
    features) on two 5-frame windows, card against CPU."""
    rng = np.random.default_rng(SEED + 73)
    paths = {'models': os.path.join(root, 'm'),
             'training_states': os.path.join(root, 's')}
    adam = {'type': 'Adam', 'lr': 2e-4, 'betas': [0.9, 0.99]}
    vrm = {'name': 'iconvsr_steps', 'model_type': 'VideoRecurrentModel',
           'is_train': True, 'num_gpu': 1, 'scale': 4,
           'network_g': dict(ICON_NET, seed=SEED), 'path': paths,
           'train': {'optim_g': adam, 'total_iter': 3, 'fix_flow': 2,
                     'flow_lr_mul': 0.125,
                     'pixel_opt': {'type': 'CharbonnierLoss',
                                   'loss_weight': 1.0, 'reduction': 'mean'}},
           'logger': {}}
    batch = {'lq': rng.uniform(0, 1, (1, 5, 3, 32, 32)).astype(np.float32),
             'gt': rng.uniform(0, 1, (1, 5, 3, 128, 128)).astype(np.float32)}
    icon = _steps_card_vs_cpu(vrm, batch, 3, ('net',), SEED + 74)
    gan = {'name': 'edvr_gan_steps', 'model_type': 'VideoGANModel',
           'is_train': True, 'num_gpu': 1, 'scale': 4,
           'network_g': dict(EDVR_M, seed=SEED),
           'network_d': {'type': 'VGGStyleDiscriminator128', 'num_in_ch': 3,
                         'num_feat': 64, 'seed': SEED},
           'path': paths,
           'train': {'optim_g': dict(adam, lr=1e-4),
                     'optim_d': dict(adam, lr=1e-4), 'total_iter': 3,
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1e-2},
                     'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                                 'loss_weight': 5e-3}},
           'logger': {}}
    batch = {'lq': rng.uniform(0, 1, (2, 5, 3, 32, 32)).astype(np.float32),
             'gt': rng.uniform(0, 1, (2, 3, 128, 128)).astype(np.float32)}
    vgan = _steps_card_vs_cpu(gan, batch, 3, ('net', 'net_d'), SEED + 75)
    emit({'phase': 'video_steps', 'iconvsr_video_recurrent_model': icon,
          'edvr_m_video_gan_model': vgan,
          'grad_tol': f'{STEP_GRAD_TOL} of each group\'s L2 norm',
          'loss_tol': f'{FP32_TOL} x max(1, |ref|)', 'fp32_tf32_off': True,
          'card': SMI})
    if icon['optimizer_counts'] != {'optimizer': 3, 'optimizer_flow': 3}:
        raise AssertionError(f'IconVSR steps: {icon}')


def _edvr_profile(model, dopt, n=1):
    """The device profile of n more train steps of the CLI's model on a
    batch of its train dataset's first items."""
    ds = build_dataset(dopt)
    items = [ds[i] for i in range(dopt['batch_size_per_gpu'])]
    model.feed_data({k: np.stack([it[k] for it in items])
                     for k in ('lq', 'gt')})

    def run():
        for i in range(n):
            model.optimize_parameters(EDVR_ITERS + 1 + i)
        torch.cuda.synchronize()
    run()                                   # the same shapes, warm
    prof = device_profile(run, n, 'edvr_steps')
    # the deformable sampling's four-corner gather and its backward's
    # scatter-add (ATen's scatter / gather kernels), and cuDNN's NHWC <->
    # NCHW conversions around some of its convs
    parts = {'dcn_gather_scatter_kernels': ('scatter', 'gather'),
             'cudnn_layout_conversions': ('nhwcToNchw', 'nchwToNhwc')}
    prof['sampling_ms_per_unit'] = {
        k: sum(ms for name, ms in prof['by_kernel']
               if any(w in name for w in words))
        for k, words in parts.items()}
    prof.pop('by_kernel')
    prof['top_device_ms_per_unit'] = prof['top_device_ms_per_unit'][:10]
    return prof


def _edvr_cli(root):
    """The train CLI on EDVR_YML (BasicSR's EDVR-M REDS widths, batch,
    data and schedule) for EDVR_ITERS iterations, TSA-only before
    EDVR_TSA_ITER; the run's one validation (after the last iteration:
    the yml's val_freq is past them)."""
    from bsvd_tpu_torch.models.sr_model import SRModel
    from bsvd_tpu_torch.models.video_base_model import EDVRModel as EM
    from bsvd_tpu_torch.models.video_base_model import VideoBaseModel as VB
    yml = os.path.join(root, 'train_EDVR_M_x4_SR_REDS_M.yml')
    with open(yml, 'w') as f:
        f.write(EDVR_YML)
    force = [*(f'datasets:{ph}:dataroot_{k}={root}/{ph}/{k}'
               for ph in ('train', 'val') for k in ('gt', 'lq')),
             'datasets:train:io_backend:type=disk',
             'path:pretrain_network_g=~', f'train:total_iter={EDVR_ITERS}',
             f'train:tsa_iter={EDVR_TSA_ITER}']
    snaps, vals = {}, []
    step, validation = EM.optimize_parameters, SRModel.validation

    def watched(model, it):
        if it == 1:
            snaps[0] = {k: v.detach().clone() for k, v in (
                ('conv_first', model.net.conv_first.weight),
                ('fusion', model.net.fusion.feat_fusion.weight))}
        step(model, it)
        if it in (1, EDVR_TSA_ITER - 1, EDVR_TSA_ITER):
            snaps[it] = {'conv_first': model.net.conv_first.weight
                         .detach().clone(),
                         'fusion': model.net.fusion.feat_fusion.weight
                         .detach().clone()}

    def timed_validation(model, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = validation(model, *a, **k)
        torch.cuda.synchronize()
        vals.append((res, time.perf_counter() - t0))
        return res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    EM.optimize_parameters, SRModel.validation = watched, timed_validation
    try:
        t0 = time.perf_counter()
        with _StepClock((VB, EM)) as clock:
            model = train_pipeline(root, cmd=['-opt', yml, '--force_yml',
                                              *force])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        EM.optimize_parameters, SRModel.validation = step, validation
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = clock.steady(EDVR_TSA_ITER + 1, EDVR_ITERS)
    opt, dopt = model.opt, model.opt['datasets']['train']
    moved = {k: {p: not torch.equal(snaps[a][p], snaps[b][p])
                 for p in ('conv_first', 'fusion')}
             for k, (a, b) in {'step_1': (0, 1),
                               'warm_2_to_tsa_minus_1': (1,
                                                         EDVR_TSA_ITER - 1),
                               'at_tsa_iter': (EDVR_TSA_ITER - 1,
                                               EDVR_TSA_ITER)}.items()}
    exp = os.path.join(root, 'experiments', opt['name'], 'models')
    val_clips = EDVR_VAL[0]
    rec = {'phase': 'video_edvr_cli',
           'source': 'BasicSR options/train/EDVR/train_EDVR_M_x4_SR_REDS_M'
                     '.yml (nets, data, schedule, loss, metric)',
           'force_yml': force, 'model': type(model).__name__,
           'network_g': opt['network_g'], 'iters': EDVR_ITERS,
           'tsa_iter': EDVR_TSA_ITER,
           'batch': dopt['batch_size_per_gpu'],
           'num_frame': dopt['num_frame'], 'gt_size': dopt['gt_size'],
           'frames_gt_lq': [[720, 1280], [180, 320]],
           'train_clips_frames': EDVR_TRAIN, 'val_clips_frames': EDVR_VAL,
           'params_g': count_params(model.net), 'wall_s': wall,
           'steady': steady,
           'wait_share': steady['data_wait_ms'] / steady['ms_per_iter'],
           'peak_allocated_gb': peak, 'losses': model.get_current_log(),
           'optimizer_counts': [model.optimizer.count,
                                model.optimizer_dcn.count],
           'moved': moved, 'validations': len(vals),
           'val_psnr': vals[0][0]['psnr'] if vals else None,
           'val_s_per_clip': vals[0][1] / val_clips if vals else None,
           'val_ms_per_frame': (vals[0][1] / (val_clips * EDVR_VAL[1]) * 1e3
                                if vals else None),
           'checkpoints': sorted(os.listdir(exp)), 'fp32_tf32_off': True,
           'card': SMI}
    emit(rec)
    want_moved = {'step_1': {'conv_first': False, 'fusion': True},
                  'warm_2_to_tsa_minus_1': {'conv_first': False,
                                            'fusion': True},
                  'at_tsa_iter': {'conv_first': True, 'fusion': True}}
    if not (len(clock.marks) == EDVR_ITERS and len(vals) == 1
            and math.isfinite(rec['val_psnr']) and moved == want_moved
            and rec['optimizer_counts'] == [EDVR_ITERS] * 2
            and 'net_g_latest.npz' in rec['checkpoints']
            and all(math.isfinite(v) for v in rec['losses'].values())):
        raise AssertionError(f'EDVR-M train CLI: {rec}')
    emit({'phase': 'video_edvr_profile', 'iterations': 1,
          **_edvr_profile(model, dopt), 'card': SMI})


def _inference_basicvsr(root, rng):
    """``bsvd_tpu_torch.inference.inference_basicvsr``'s ``main(argv)`` on
    a 20-frame 64 x 64 folder with random BasicVSR (64 x 30) weights saved
    here: the output count and shapes, its seconds."""
    from bsvd_tpu_torch.convert.torch_generic import to_jax_tree
    from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite
    ckpt = os.path.join(root, 'basicvsr.npz')
    save_npz_params(ckpt, {'params': to_jax_tree(build_network(
        {'type': 'BasicVSR', 'num_feat': 64, 'num_block': 30,
         'seed': SEED}, 'cpu'))})
    frames, out = os.path.join(root, 'frames'), os.path.join(root, 'vsr')
    for i in range(20):
        imwrite(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8),
                os.path.join(frames, f'{i:08d}.png'))
    seconds = _run_main('bsvd_tpu_torch.inference.inference_basicvsr', [
        '--model_path', ckpt, '--input_path', frames, '--save_path', out])
    shapes = {}
    for f in sorted(os.listdir(out)):
        with open(os.path.join(out, f), 'rb') as fh:
            shapes[f] = list(imfrombytes(fh.read(), 'color').shape)
    rec = {'phase': 'video_inference_basicvsr', 'frames': 20,
           'interval': 15, 'main_s': seconds, 'outputs': len(shapes),
           'shapes': sorted({tuple(s) for s in shapes.values()}),
           'card': SMI}
    emit(rec)
    if sorted(shapes) != [f'{i:08d}_BasicVSR.png' for i in range(20)] \
            or rec['shapes'] != [(256, 256, 3)]:
        raise AssertionError(f'inference_basicvsr: {rec}')


def phase_video_family():
    """Phase 20: the rest of the zoo's video family. No kernel of the port
    is on these paths (plain PyTorch, as the JAX package's XLA): the
    kernels line is unchanged."""
    t0 = time.perf_counter()
    root = os.path.join(WORK, 'video_family')
    rng = np.random.default_rng(SEED + 76)
    _video_parity()
    _video_steps(root)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futures = (_vsr_clips(os.path.join(root, 'train'), *EDVR_TRAIN, 720,
                              1280, rng, pool)
                   + _vsr_clips(os.path.join(root, 'val'), *EDVR_VAL, 720,
                                1280, rng, pool))
        for f in futures:
            f.result()
    emit({'phase': 'video_edvr_data', 'write_s': time.perf_counter() - t1,
          'train': EDVR_TRAIN, 'val': EDVR_VAL, 'gt_hw': [720, 1280],
          'lq_hw': [180, 320]})
    _edvr_cli(root)
    _inference_basicvsr(root, rng)
    emit({'phase': 'video_family', 'seconds': time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 21: faces and degradations (utils/cv2_ops; FaceRestorationHelper
# and DFDNet; prepare_hifacegan_dataset; USM, the degradation noise, NIQE)
# ---------------------------------------------------------------------------

# DFDNet's synthetic dictionary (none is in the repository): 32 atoms per
# part at each feature size, spatial 24 / 12 / 6 / 3 at feature sizes
# 256 / 128 / 64 / 32 (channels 128 / 256 / 512 / 512, the net's)
DFD_ATOMS = 32
DFD_ATOM_HW = {'256': (128, 24), '128': (256, 12), '64': (512, 6),
               '32': (512, 3)}
# the frame a 512 x 512 face is cropped from and pasted back into (x2)
DFD_FRAME = 1024
# the 68-landmark part centres and spreads on the 512 crop
DFD_PARTS = {'left_eye': ((190, 245), 22), 'right_eye': ((322, 245), 22),
             'nose': ((256, 318), 18), 'mouth': ((256, 392), 30)}
HFG_N = 8
NIQE_HW = (480, 640)


def _card_ms(fn, reps=5):
    """(fn's result, median ms of ``reps`` runs after one warm-up, peak MiB
    allocated above what was allocated before)."""
    out = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(fn, reps, 0)
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def _same(name, got, ref, tol=1e-5):
    """A card result against the CPU's: uint8 bit for bit, else within
    ``tol``; returns the max |diff|."""
    got = got.cpu()
    if got.dtype == torch.uint8:
        err = (got.int() - ref.int()).abs().max().item()
        ok = err == 0
    else:
        err = (got.double() - ref.double()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(got).all())
    if got.shape != ref.shape or not ok:
        raise AssertionError(f'{name}: card against CPU {err} '
                             f'{tuple(got.shape)} {tuple(ref.shape)}')
    return err


def _motion(k, angle):
    from bsvd_tpu_torch.scripts.data_preparation.prepare_hifacegan_dataset \
        import _motion_kernel
    return _motion_kernel(k, angle, 'cpu')


def _cv2_ops_card(rng):
    """Each cv2_ops operation on card tensors against the CPU at its
    callers' sizes (the paste-back's float32 warp, erosion and feathering
    at 2048 x 2048 are held in _faces_paste)."""
    from bsvd_tpu_torch.utils import cv2_ops as co
    from bsvd_tpu_torch.utils.face_util import umeyama_similarity
    frame = torch.from_numpy(rng.integers(0, 256, (DFD_FRAME, DFD_FRAME, 3),
                                          dtype=np.uint8))
    face = frame[:512, :512].contiguous()
    small = co.resize(face, (128, 128), co.INTER_AREA)
    frac = co.resize(face, (87, 87), co.INTER_AREA)
    f512 = face.float() / 255
    gray = torch.from_numpy(rng.random(NIQE_HW + (3,)).astype(np.float32))
    tmpl = np.array([[686.77227723, 488.62376238],
                     [586.77227723, 493.59405941],
                     [337.91089109, 488.38613861],
                     [437.95049505, 493.51485149],
                     [513.58415842, 678.5049505]]) / 2
    lm = tmpl * 0.5 + np.array([380.0, 400.0])
    fwd, inv = umeyama_similarity(lm, tmpl), umeyama_similarity(tmpl, lm * 2)
    cases = [
        ('resize INTER_LINEAR x2 (face_util)', frame,
         lambda x: co.resize(x, (2048, 2048))),
        ('resize INTER_AREA 512->128 (sr4x)', face,
         lambda x: co.resize(x, (128, 128), co.INTER_AREA)),
        ('resize INTER_AREA 512->87 (sr4x8x)', face,
         lambda x: co.resize(x, (87, 87), co.INTER_AREA)),
        ('resize INTER_CUBIC 128->512', small,
         lambda x: co.resize(x, (512, 512), co.INTER_CUBIC)),
        ('resize INTER_CUBIC 87->512', frac,
         lambda x: co.resize(x, (512, 512), co.INTER_CUBIC)),
        ('warp_affine uint8 frame->512 crop', frame,
         lambda x: co.warp_affine(x, fwd, (512, 512))),
        ('warp_affine uint8 512->2048 back', face,
         lambda x: co.warp_affine(x, inv, (2048, 2048))),
        ('gaussian_blur uint8 19 sigma 3', face,
         lambda x: co.gaussian_blur(x, (19, 19), 3.0)),
        ('gaussian_blur uint8 49 sigma 8', face,
         lambda x: co.gaussian_blur(x, (49, 49), 8.0)),
        ('gaussian_blur float32 51 sigma 0 (usm)', f512,
         lambda x: co.gaussian_blur(x, (51, 51), 0)),
        ('filter2d uint8 motion 11', face,
         lambda x: co.filter2d(x, -1, _motion(11, 33.0))),
        ('filter2d uint8 motion 20', face,
         lambda x: co.filter2d(x, -1, _motion(20, 251.0))),
        ('erode float32 4 x 4', f512, lambda x: co.erode(x, np.ones((4, 4), np.uint8))),
        ('cvt_color float32 BGR2GRAY', gray,
         lambda x: co.cvt_color(x, co.COLOR_BGR2GRAY)),
    ]
    out = []
    for name, x, fn in cases:
        ref = fn(x)
        xc = x.cuda()
        got, ms, peak = _card_ms(lambda: fn(xc))
        out.append({'op': name, 'in': list(x.shape), 'dtype': str(x.dtype),
                    'max_abs_err': _same(name, got, ref), 'card_ms': ms,
                    'peak_mib': peak})
    emit({'phase': 'faces_cv2_ops', 'ops': out,
          'rule': 'uint8 bit-equal, float32 1e-5 (card against CPU)'})


def _dfd_dict(rng):
    return {s: {p: rng.standard_normal((DFD_ATOMS, c, hw, hw)).astype(
        np.float32) for p in DFD_PARTS} for s, (c, hw) in DFD_ATOM_HW.items()}


def _lm68(rng):
    """68 landmarks on the 512 crop: each part's points around its
    centre (the others, 0-16 and 27-28, on the jaw and the bridge)."""
    from bsvd_tpu_torch.inference.inference_dfdnet import get_part_location
    lm = np.zeros((68, 2))
    lm[:17] = np.stack([np.linspace(120, 392, 17), 400 + 60 * np.sin(
        np.linspace(0, np.pi, 17))], 1)
    idx = {'left_eye': list(range(17, 22)) + list(range(36, 42)),
           'right_eye': list(range(22, 27)) + list(range(42, 48)),
           'nose': list(range(27, 36)), 'mouth': list(range(48, 68))}
    for part, ((cx, cy), spread) in DFD_PARTS.items():
        lm[idx[part]] = np.array([cx, cy]) + rng.uniform(
            -spread, spread, (len(idx[part]), 2))
    return lm, get_part_location(lm)


def _faces_dfdnet(rng):
    """FaceRestorationHelper with given landmarks (dlib is absent) on a
    DFD_FRAME x DFD_FRAME frame, DFDNet at num_feat 64 on the 512 x 512
    crop: card against CPU (the chosen atoms equal, the output within
    1e-4 x max|ref|), ms a face, ms of the paste-back at upscale 2, peak
    memory."""
    from bsvd_tpu_torch.archs.dfdnet_arch import DFDNet
    from bsvd_tpu_torch.utils.face_util import FaceRestorationHelper
    from bsvd_tpu_torch.utils.img_util import tensor2img
    frame = _faces(1, DFD_FRAME, rng)[0].permute(1, 2, 0).to(torch.uint8)
    helper = FaceRestorationHelper(2, 512, device='cuda')
    lm5 = helper.face_template * 0.5 + np.array([380.0, 400.0])
    helper.input_img = frame
    helper.all_landmarks_5 = [lm5]
    _, crop_ms, _ = _card_ms(lambda: (helper.cropped_faces.clear(),
                                      helper.affine_matrices.clear(),
                                      helper.inverse_affine_matrices.clear(),
                                      helper.warp_crop_faces()))
    crop = helper.cropped_faces[0]
    _, locs = _lm68(rng)
    net = DFDNet(64, face_dict=_dfd_dict(rng), seed=SEED)
    with torch.no_grad():
        # random weights put the tanh's input near 1e4: scale the last conv
        # so the output is not saturated and the comparison means something
        net.upsample4[4].weight.mul_(3e-5)
        net.upsample4[4].bias.mul_(3e-5)
    x = ((crop.float() / 255. - 0.5) / 0.5).permute(2, 0, 1)[None]
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = net(x.cpu().contiguous(), locs)
    cpu_s = time.perf_counter() - t0
    atoms_cpu = dict(net.last_atoms)
    card = net.to('cuda')
    xc = x.contiguous()
    with torch.no_grad():
        out, ms, peak = _card_ms(lambda: card(xc, locs))
    err, scale = (out.cpu() - ref).abs().max().item(), ref.abs().max().item()

    def three():
        with torch.no_grad():
            for _ in range(3):
                card(xc, locs)
        torch.cuda.synchronize()
    prof = device_profile(three, 3, 'dfdnet_faces')
    prof.pop('by_kernel')
    prof['top_device_ms_per_unit'] = prof['top_device_ms_per_unit'][:8]
    if card.last_atoms != atoms_cpu or not err <= FP32_TOL * scale \
            or not torch.isfinite(out).all() or not 0.05 < scale < 0.999:
        raise AssertionError(f'DFDNet card vs CPU: err {err}, max|ref| '
                             f'{scale}, atoms {card.last_atoms} / '
                             f'{atoms_cpu}')
    emit({'phase': 'faces_dfdnet', 'num_feat': 64, 'face': [512, 512],
          'dict_atoms': DFD_ATOMS, 'dict_atom_shapes': {
              s: [DFD_ATOMS, c, hw, hw] for s, (c, hw) in
              DFD_ATOM_HW.items()},
          'part_boxes': [loc[0].tolist() for loc in locs],
          'atoms': {f'{fs}/{p}': i for (fs, p), i in atoms_cpu.items()},
          'max_abs_err': err, 'max_abs_ref': scale, 'tol': f'{FP32_TOL} x '
          'max|ref|', 'ms_per_face': ms, 'peak_mib': peak, 'cpu_s': cpu_s,
          'crop_ms': crop_ms, 'profile': prof, 'card': SMI})
    restored = tensor2img(out[0].cpu().numpy(), min_max=(-1, 1))
    del card, out
    _faces_paste(helper, restored, frame)


def _faces_paste(helper, restored, frame):
    """paste_faces_to_input_image at upscale 2 (a 2048 x 2048 output: the
    float32 warps, erosions and feathering at that size, and the PNG
    write), card against the CPU helper on the same inputs."""
    from bsvd_tpu_torch.utils.face_util import FaceRestorationHelper
    helper.add_restored_face(restored)
    path = os.path.join(WORK, 'faces_paste', 'card.png')
    out, ms, peak = _card_ms(lambda: helper.paste_faces_to_input_image(path),
                             reps=3)
    cpu = FaceRestorationHelper(2, 512, device='cpu')
    cpu.input_img = frame.cpu()
    cpu.inverse_affine_matrices = list(helper.inverse_affine_matrices)
    cpu.add_restored_face(restored)
    t0 = time.perf_counter()
    ref = cpu.paste_faces_to_input_image(path.replace('card', 'cpu'))
    cpu_s = time.perf_counter() - t0
    err = _same('paste_faces_to_input_image', out, ref, 1e-3)
    png = [png_decode.load(path.replace('card', k)) for k in ('card', 'cpu')]
    if not np.array_equal(*png):
        raise AssertionError('paste_faces_to_input_image: the written '
                             'frames differ')
    emit({'phase': 'faces_paste', 'frame': [DFD_FRAME, DFD_FRAME],
          'upscale': 2, 'out': list(out.shape), 'max_abs_err': err,
          'png_equal': True, 'ms': ms, 'peak_mib': peak, 'cpu_s': cpu_s,
          'card': SMI})


def _hifacegan_prep(root, rng):
    """Every prepare_hifacegan_dataset template over HFG_N GT faces at 512
    on the card, the script's LQ files equal to its CPU run's; ms a GT
    face (the template on a card tensor, synchronized), the script's
    seconds, peak memory."""
    from bsvd_tpu_torch.scripts.data_preparation import \
        prepare_hifacegan_dataset as prep
    gt_dir = os.path.join(root, 'gt')
    gt = _faces(HFG_N, 512, rng)
    with ThreadPoolExecutor(8) as pool:
        for f in _write_faces(gt_dir, gt, pool):
            f.result()
    bgr = gt.permute(0, 2, 3, 1).flip(-1).to(torch.uint8)
    out = []
    for i, deg in enumerate(prep.DEG_TEMPLATES):
        seed = SEED + 90 + i
        dirs = {k: os.path.join(root, f'{deg}_{k}') for k in ('cuda', 'cpu')}
        secs = {}
        for k, d in dirs.items():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                prep.create_training_dataset(deg, gt_dir, d, seed, device=k)
            secs[k] = time.perf_counter() - t0
        names = sorted(os.listdir(dirs['cuda']))
        if names != sorted(os.listdir(dirs['cpu'])) or len(names) != HFG_N:
            raise AssertionError(f'{deg}: {names}')
        for n in names:
            a, b = (png_decode.load(os.path.join(dirs[k], n)) for k in dirs)
            if not np.array_equal(a, b):
                raise AssertionError(f'{deg} {n}: card LQ != CPU LQ')
        face_rng = np.random.default_rng(seed)
        times = []
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for b in bgr:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep.degrade(b, deg, face_rng, 'cuda')
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.append({'template': deg, 'ms_per_face_median': statistics.median(
            times), 'ms_per_face_first': times[0],
            'script_s_card': secs['cuda'], 'script_s_cpu': secs['cpu'],
            'peak_mib': (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
            'lq_equal_cpu': True})
    emit({'phase': 'faces_hifacegan_prep', 'gt': [HFG_N, 512, 512],
          'templates': out, 'card': SMI})


def _niqe_params(path, seed):
    """A synthetic NIQE parameter file (a seeded mean and positive-definite
    covariance of the real shapes; the repository has none)."""
    r = np.random.default_rng(seed)
    a = r.standard_normal((36, 36))
    np.savez(path, mu_pris_param=r.uniform(0.2, 3.0, (1, 36)),
             cov_pris_param=a @ a.T / 36 + 0.5 * np.eye(36))
    return path


def _usm_noise_niqe(rng):
    """usm_sharp (one frame) and usm_sharp_torch (a batch), the batched
    degradation noise on a given noise tensor, NIQE on a NIQE_HW frame:
    card against CPU, card ms and peak memory."""
    from bsvd_tpu_torch.data.degradations import add_gaussian_noise_torch
    from bsvd_tpu_torch.metrics.niqe import calculate_niqe
    from bsvd_tpu_torch.utils.img_process_util import (usm_sharp,
                                                       usm_sharp_torch)
    rec = {}
    batch = (_faces(8, 512, rng) / 255).permute(0, 2, 3, 1).contiguous()
    one = batch[0].contiguous()
    cpu_b, cpu_1 = batch.cpu(), one.cpu()
    ref = usm_sharp(cpu_1)
    got, ms, peak = _card_ms(lambda: usm_sharp(one))
    rec['usm_sharp 512'] = {'max_abs_err': _same('usm_sharp', got, ref),
                            'ms': ms, 'peak_mib': peak}
    # the batched form blurs with cuDNN on the card: a residual within fp32
    # rounding of the threshold flips its mask (2.4e-4 of the output on an
    # H100), so card and CPU are held in float64, the time taken in fp32
    ref = usm_sharp_torch(cpu_b.double())
    err = _same('usm_sharp_torch', usm_sharp_torch(batch.double()), ref, 1e-9)
    _, ms, peak = _card_ms(lambda: usm_sharp_torch(batch))
    rec['usm_sharp_torch 8 x 512'] = {'max_abs_err_float64': err, 'ms': ms,
                                      'peak_mib': peak}
    sigma = torch.tensor(rng.uniform(1, 30, 8), dtype=torch.float32)
    noise = torch.from_numpy(rng.standard_normal(batch.shape).astype(
        np.float32))
    gray = torch.from_numpy(rng.standard_normal(batch.shape[:3] + (1,))
                            .astype(np.float32))
    ref = add_gaussian_noise_torch(cpu_b, sigma, (1, 0) * 4, noise=noise,
                                   gray=gray)
    nc, gc, sc = noise.cuda(), gray.cuda(), sigma.cuda()
    got, ms, peak = _card_ms(lambda: add_gaussian_noise_torch(
        batch, sc, (1, 0) * 4, noise=nc, gray=gc))
    rec['add_gaussian_noise_torch 8 x 512'] = {
        'max_abs_err': _same('noise', got, ref, 1e-6), 'ms': ms,
        'peak_mib': peak}
    params = _niqe_params(os.path.join(WORK, 'niqe_synthetic.npz'),
                          SEED + 95)
    img = (_faces(1, NIQE_HW[1], rng)[0, :, :NIQE_HW[0]].permute(1, 2, 0)
           .flip(-1).to(torch.uint8).contiguous())
    t0 = time.perf_counter()
    ref = calculate_niqe(img.cpu(), 0, niqe_pris_params=params)
    cpu_s = time.perf_counter() - t0
    got, ms, peak = _card_ms(lambda: calculate_niqe(
        img, 0, niqe_pris_params=params), reps=3)
    if not abs(got - ref) <= 1e-5 * abs(ref) or not math.isfinite(got):
        raise AssertionError(f'NIQE card {got} CPU {ref}')
    rec['niqe 480 x 640'] = {'card': got, 'cpu': ref, 'ms': ms,
                             'peak_mib': peak, 'cpu_s': cpu_s,
                             'params': 'synthetic (seeded mean, PD cov)'}
    emit({'phase': 'faces_usm_noise_niqe', 'checks': rec, 'card': SMI})


def phase_faces_degradations():
    """Phase 21: faces and degradations. No kernel of the port is on these
    paths (cv2_ops and DFDNet are plain PyTorch, as the JAX package's
    numpy / cv2 / XLA): the kernels line is unchanged."""
    t0 = time.perf_counter()
    root = os.path.join(WORK, 'faces_degradations')
    rng = np.random.default_rng(SEED + 91)
    _cv2_ops_card(rng)
    _faces_dfdnet(rng)
    _hifacegan_prep(root, rng)
    _usm_noise_niqe(rng)
    emit({'phase': 'faces_degradations',
          'seconds': time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 22: SwinIR, FID, LPIPS, DiffJPEG
# ---------------------------------------------------------------------------

# BasicSR's options/train/SwinIR/train_SwinIR_SRx2_scratch.yml (classical
# SR x2 at the released widths, DIV2K pairs, batch 4 of 96 px GT, Adam 2e-4
# (0.9, 0.99), MultiStepLR, L1, EMA 0.999); the phase points its folders at
# synthetic pairs with --force_yml
SWINIR_YML = """name: train_SwinIR_SRx2_scratch_P48W8_DIV2K_500k_B4G8
model_type: SwinIRModel
scale: 2
num_gpu: auto
manual_seed: 0
datasets:
  train:
    name: DIV2K
    type: PairedImageDataset
    dataroot_gt: datasets/DF2K/DIV2K_train_HR_sub
    dataroot_lq: datasets/DF2K/DIV2K_train_LR_bicubic_X2_sub
    meta_info_file: basicsr/data/meta_info/meta_info_DIV2K800sub_GT.txt
    filename_tmpl: '{}'
    io_backend:
      type: disk
    gt_size: 96
    use_hflip: true
    use_rot: true
    use_shuffle: true
    num_worker_per_gpu: 6
    batch_size_per_gpu: 4
    dataset_enlarge_ratio: 1
    prefetch_mode: ~
  val:
    name: Set5
    type: PairedImageDataset
    dataroot_gt: datasets/Set5/GTmod12
    dataroot_lq: datasets/Set5/LRbicx2
    io_backend:
      type: disk
network_g:
  type: SwinIR
  upscale: 2
  in_chans: 3
  img_size: 48
  window_size: 8
  img_range: 1.
  depths: [6, 6, 6, 6, 6, 6]
  embed_dim: 180
  num_heads: [6, 6, 6, 6, 6, 6]
  mlp_ratio: 2
  upsampler: 'pixelshuffle'
  resi_connection: '1conv'
path:
  pretrain_network_g: ~
  strict_load_g: true
  resume_state: ~
train:
  ema_decay: 0.999
  optim_g:
    type: Adam
    lr: !!float 2e-4
    weight_decay: 0
    betas: [0.9, 0.99]
  scheduler:
    type: MultiStepLR
    milestones: [250000, 400000, 450000, 475000]
    gamma: 0.5
  total_iter: 500000
  warmup_iter: -1
  pixel_opt:
    type: L1Loss
    loss_weight: 1.0
    reduction: mean
val:
  val_freq: !!float 5e3
  save_img: false
  metrics:
    psnr:
      type: calculate_psnr
      crop_border: 2
      test_y_channel: true
logger:
  print_freq: 100
  save_checkpoint_freq: !!float 5e3
  use_tb_logger: true
  wandb:
    project: ~
    resume_id: ~
dist_params:
  backend: nccl
  port: 29500
"""


SWINIR_LR = (678, 1020)     # a DIV2K x2 LR frame (padded to 680 x 1024)
SWINIR_ITERS = 20
# DIV2K800sub's 480 x 480 GT crops (240 x 240 LR) and Set5-sized val pairs
SWINIR_TRAIN, SWINIR_GT = 16, 480
SWINIR_VAL, SWINIR_VAL_GT = 2, 252
# the card against the CPU in fp32 (TF32 off): 1e-4 x max|ref| for
# outputs and features, 1e-3 of each optimizer group's L2 for gradients
# (summation order only: no sampling or scatter on these paths)
P22_TOL, P22_GRAD_TOL = 1e-4, 1e-3
FID_N, FID_HW, INCEPTION_BATCH = 256, 256, 64
LPIPS_PAIRS, LPIPS_HW = 16, 512
# Real-ESRGAN's degradation batch
JPEG_SHAPE, JPEG_Q = (12, 3, 256, 256), (30, 95)


def _p22_close(name, got, ref, tol=P22_TOL):
    """A card tensor against the CPU's: max |diff| within tol x max|ref|;
    returns (max |diff|, max |ref|)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if got.shape != ref.shape or not err <= tol * scale \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f'{name}: card against CPU {err} (max|ref| '
                             f'{scale}) {tuple(got.shape)}')
    return err, scale


def _swinir_yml():
    return yaml_load(SWINIR_YML)


def _kernel_shares(prof):
    """A device profile's kernels in groups (ms per unit): GEMMs and
    cuDNN's implicit-GEMM convs, softmax, LayerNorm, GELU, copies / layout
    changes, the rest (elementwise, reductions)."""
    groups = {'gemm_conv': ('gemm', 'cutlass', 'xmma', 'nvjet', 'sm90_'),
              'softmax': ('softmax',), 'layer_norm': ('layer_norm',),
              'gelu': ('gelu',), 'copy_layout': ('copy', 'cat', 'index',
                                                 'roll', 'transpose')}
    out = dict.fromkeys([*groups, 'other'], 0.0)
    for name, ms in prof['by_kernel']:
        low = name.lower()
        key = next((g for g, words in groups.items()
                    if any(w in low for w in words)), 'other')
        out[key] += ms
    return out


def _swinir_forward(rng, dev='cuda'):
    """SWINIR_YML's network_g (random weights from the seed) on a DIV2K x2
    LR frame in fp32 and under bf16 autocast: ms a frame, peak GB; the
    card against the CPU in fp32 on a 64 x 64 crop."""
    net = build_network(dict(_swinir_yml()['network_g'], seed=SEED),
                        dev).eval()
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3) + SWINIR_LR).astype(
        np.float32)).to(dev)
    rec, outs = {}, {}
    with torch.no_grad():
        for dtype in ('fp32', 'bf16'):
            def run():
                with torch.autocast(dev, torch.bfloat16,
                                    enabled=dtype == 'bf16'):
                    return net(x)
            torch.cuda.empty_cache()
            out, ms, _ = _card_ms(run, reps=3)
            outs[dtype] = out.float()
            rec[dtype] = {'ms_per_frame': ms,
                          'peak_allocated_gb':
                          torch.cuda.max_memory_allocated() / 1e9}
        crop = x[:, :, :64, :64]
        cpu_net = copy.deepcopy(net).cpu()
        err, scale = _p22_close('swinir fp32 64x64', net(crop),
                                cpu_net(crop.cpu()))
        profiles = {}
        if dev == 'cuda':
            for dtype in ('fp32', 'bf16'):
                def once():
                    with torch.autocast(dev, torch.bfloat16,
                                        enabled=dtype == 'bf16'):
                        net(x)
                    torch.cuda.synchronize()
                prof = device_profile(once, 1, f'swinir_{dtype}')
                prof['groups_ms'] = _kernel_shares(prof)
                prof.pop('by_kernel')
                prof['top_device_ms_per_unit'] = \
                    prof['top_device_ms_per_unit'][:8]
                profiles[dtype] = prof
    shape = list(outs['fp32'].shape)
    rec = {'phase': 'swinir_forward', 'network_g': _swinir_yml()['network_g'],
           'params': count_params(net), 'lr_hw': list(SWINIR_LR),
           'out_shape': shape, **rec,
           'bf16_psnr_vs_fp32': psnr(outs['bf16'], outs['fp32']),
           'profile_one_frame': profiles,
           'card_vs_cpu_fp32_64': {'max_abs_err': err, 'max_ref': scale,
                                   'tol': f'{P22_TOL} x max|ref|'},
           'fp32_tf32_off': True, 'card': SMI}
    emit(rec)
    if shape != [1, 3, 2 * SWINIR_LR[0], 2 * SWINIR_LR[1]] or not all(
            bool(torch.isfinite(o).all()) for o in outs.values()):
        raise AssertionError(f'SwinIR forward: {rec}')
    return net


def _swinir_pairs(root, rng, pool):
    """Futures of the train and val PNG pairs: GT of random 4 x 4 colour
    blocks, LR its 2 x 2 mean."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    futures = []
    for split, n, hw in (('train', SWINIR_TRAIN, SWINIR_GT),
                         ('val', SWINIR_VAL, SWINIR_VAL_GT)):
        for i in range(n):
            base = rng.integers(0, 256, (hw // 4, hw // 4, 3))
            gt = np.kron(base, np.ones((4, 4, 1))).astype(np.uint8)
            lq = gt.reshape(hw // 2, 2, hw // 2, 2, 3).mean((1, 3)).round()
            futures += [pool.submit(imwrite, gt, os.path.join(
                root, split, 'gt', f'{i:04d}.png')), pool.submit(
                imwrite, lq.astype(np.uint8), os.path.join(
                    root, split, 'lq', f'{i:04d}.png'))]
    return futures


def _swinir_profile(model, dopt, n=1):
    """The device profile of n more train steps of the CLI's model on a
    batch of its train dataset's first items, its kernels grouped."""
    ds = build_dataset(dopt)
    items = [ds[i] for i in range(dopt['batch_size_per_gpu'])]
    model.feed_data({k: np.stack([it[k] for it in items])
                     for k in ('lq', 'gt')})

    def run():
        for i in range(n):
            model.optimize_parameters(SWINIR_ITERS + 1 + i)
        torch.cuda.synchronize()
    run()                                   # the same shapes, warm
    prof = device_profile(run, n, 'swinir_steps')
    prof['groups_ms'] = _kernel_shares(prof)
    prof.pop('by_kernel')
    prof['top_device_ms_per_unit'] = prof['top_device_ms_per_unit'][:8]
    return prof


def _swinir_cli(root, dev='cuda'):
    """The train CLI on SWINIR_YML for SWINIR_ITERS iterations on the
    phase's pairs (folders and meta_info_file forced), its one validation
    after the last (the yml's val_freq is past them); then one step's
    gradients, card against CPU."""
    from bsvd_tpu_torch.models.sr_model import SRModel
    yml = os.path.join(root, 'train_SwinIR_SRx2_scratch.yml')
    with open(yml, 'w') as f:
        f.write(SWINIR_YML)
    force = [*(f'datasets:{ph}:dataroot_{k}={root}/{ph}/{k}'
               for ph in ('train', 'val') for k in ('gt', 'lq')),
             'datasets:train:meta_info_file=~',
             f'train:total_iter={SWINIR_ITERS}', 'logger:print_freq=10',
             f'logger:save_checkpoint_freq={SWINIR_ITERS}']
    vals, validation = [], SRModel.validation

    def timed_validation(model, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = validation(model, *a, **k)
        torch.cuda.synchronize()
        vals.append((res, time.perf_counter() - t0))
        return res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    SRModel.validation = timed_validation
    try:
        t0 = time.perf_counter()
        with _StepClock((SRModel,)) as clock:
            model = train_pipeline(root, cmd=['-opt', yml, '--device', dev,
                                              '--force_yml', *force])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        SRModel.validation = validation
    steady = clock.steady(11, SWINIR_ITERS)
    opt, dopt = model.opt, model.opt['datasets']['train']
    exp = os.path.join(root, 'experiments', opt['name'], 'models')
    rec = {'phase': 'swinir_train_cli',
           'source': 'BasicSR options/train/SwinIR/train_SwinIR_SRx2_scratch'
                     '.yml (net, data, optimizer, schedule, loss, EMA, '
                     'metric)', 'force_yml': force,
           'model': type(model).__name__, 'iters': SWINIR_ITERS,
           'batch': dopt['batch_size_per_gpu'], 'gt_size': dopt['gt_size'],
           'train_pairs': SWINIR_TRAIN, 'gt_hw': [SWINIR_GT] * 2,
           'wall_s': wall, 'steady': steady,
           'wait_share': steady['data_wait_ms'] / steady['ms_per_iter'],
           'peak_allocated_gb': torch.cuda.max_memory_allocated() / 1e9,
           'losses': model.get_current_log(),
           'optimizer_count': model.optimizer.count,
           'validations': len(vals),
           'val_psnr': float(vals[0][0]['psnr']) if vals else None,
           'val_s': vals[0][1] if vals else None,
           'val_images': SWINIR_VAL,
           'checkpoints': sorted(os.listdir(exp)), 'fp32_tf32_off': True,
           'card': SMI}
    emit(rec)
    if not (type(model).__name__ == 'SwinIRModel'
            and len(clock.marks) == SWINIR_ITERS and len(vals) == 1
            and model.optimizer.count == SWINIR_ITERS
            and math.isfinite(rec['val_psnr'])
            and model.net_g_ema is not None
            and 'net_g_latest.npz' in rec['checkpoints']
            and all(math.isfinite(v) for v in rec['losses'].values())):
        raise AssertionError(f'SwinIR train CLI: {rec}')
    if dev == 'cuda':
        emit({'phase': 'swinir_train_profile', 'iterations': 3,
              **_swinir_profile(model, dopt), 'card': SMI})
    yopt = _swinir_yml()
    step_opt = {'name': 'swinir_step', 'model_type': 'SwinIRModel',
                'is_train': True, 'num_gpu': 1, 'scale': 2,
                'network_g': dict(yopt['network_g'], seed=SEED),
                'path': {'models': os.path.join(root, 'm'),
                         'training_states': os.path.join(root, 's')},
                'train': yopt['train'], 'logger': {}}
    rng = np.random.default_rng(SEED + 102)
    batch = {'lq': rng.uniform(0, 1, (2, 3, 48, 48)).astype(np.float32),
             'gt': rng.uniform(0, 1, (2, 3, 96, 96)).astype(np.float32)}
    step = _steps_card_vs_cpu(step_opt, batch, 1, ('net',), SEED)
    emit({'phase': 'swinir_step_grad', 'batch': [2, 48, 48], **step,
          'grad_tol': f'{P22_GRAD_TOL} of the group\'s L2 norm',
          'fp32_tf32_off': True, 'card': SMI})
    if not step['steps'][0]['optimizer']['l2_over_l2'] <= P22_GRAD_TOL:
        raise AssertionError(f'SwinIR step card vs CPU: {step}')


def _swinir_inference_job(root, net, rng, dev):
    """The ``inference_swinir`` command (classical SR x2) on two LR PNGs
    with the phase's random weights as a ``.pth`` under ``params``, and
    its check: the outputs' names and shapes."""
    from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite
    ckpt = os.path.join(root, 'swinir_x2.pth')
    torch.save({'params': {k: v.cpu() for k, v in net.state_dict().items()}},
               ckpt)
    src, out = os.path.join(root, 'lr'), os.path.join(root, 'swinir_out')
    for name, hw in (('a', (96, 128)), ('b', (75, 61))):
        imwrite(rng.integers(0, 256, hw + (3,)).astype(np.uint8),
                os.path.join(src, f'{name}.png'))

    def check(lines, rec):
        shapes = {}
        for f in sorted(os.listdir(out)):
            with open(os.path.join(out, f), 'rb') as fh:
                shapes[f] = list(imfrombytes(fh.read(), 'color').shape)
        rec['outputs'] = shapes
        return shapes == {'a_SwinIR.png': [192, 256, 3],
                          'b_SwinIR.png': [150, 122, 3]}
    return ('inference_swinir',
            ['bsvd_tpu_torch.inference.inference_swinir', '--model_path',
             ckpt, '--input', src, '--output', out, '--task',
             'classical_sr', '--scale', '2', '--device', dev], {}, root,
            check)


def _run_main(module, argv):
    """``module.main(argv)`` in this process (what ``python -m module``
    runs, without a process start), its output set aside; its seconds."""
    import importlib
    mod = importlib.import_module(module)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main(list(argv))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _run_jobs(jobs):
    """Run each job's command (``python -m``) at once, in threads; each
    job is (name, args, env, cwd, check(lines, rec) -> ok). Returns
    {name: record with its command seconds}; raises at the first failed
    check."""
    def one(job):
        name, args, env, cwd, check = job
        t0 = time.perf_counter()
        lines = _run_module(args, 600, cwd=cwd, env=env)
        rec = {'command_s': time.perf_counter() - t0}
        if not check(lines, rec):
            raise AssertionError(f'{name}: {rec} {lines[-5:]}')
        return name, rec
    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(f.result() for f in [pool.submit(one, j) for j in jobs])


def _inception_pth(path, seed):
    """A torchvision-layout FID Inception state dict of random weights
    (He-normal convs, random BN statistics), saved as a ``.pth``."""
    from bsvd_tpu_torch.archs.inception_arch import InceptionV3
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in InceptionV3().state_dict().items():
        if 'num_batches_tracked' in k:
            state[k] = v
        elif 'running_var' in k:
            state[k] = torch.rand(v.shape, generator=gen) + 0.5
        elif k.endswith('bn.weight'):
            state[k] = 1 + 0.1 * torch.randn(v.shape, generator=gen)
        elif 'conv.weight' in k:
            state[k] = torch.randn(v.shape, generator=gen) * math.sqrt(
                2.0 / v[0].numel())
        else:
            state[k] = 0.1 * torch.randn(v.shape, generator=gen)
    torch.save(state, path)
    return path


def _inception(pth, rng, dev='cuda'):
    """The patched InceptionV3 at a batch of 64 images of 256 x 256
    (resized to 299): ms a batch, images a second, peak GB; card against
    CPU features on 4 images."""
    from bsvd_tpu_torch.metrics.fid import (extract_inception_features,
                                            load_patched_inception_v3)
    net = load_patched_inception_v3(pretrain_path=pth, device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (INCEPTION_BATCH, 3, FID_HW,
                                             FID_HW)).astype(np.float32))
    xc = x.to(dev)
    torch.cuda.empty_cache()
    with torch.no_grad():
        _, ms, _ = _card_ms(lambda: net(xc), reps=10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    cpu_net = copy.deepcopy(net).cpu()
    got = extract_inception_features([x[:4].numpy()], net)
    ref = extract_inception_features([x[:4].numpy()], cpu_net)
    err, scale = _p22_close('inception features', torch.from_numpy(got),
                            torch.from_numpy(ref))
    rec = {'phase': 'inception', 'batch': [INCEPTION_BATCH, 3, FID_HW,
                                           FID_HW],
           'resized_to': 299, 'ms_per_batch': ms,
           'images_per_s': INCEPTION_BATCH / ms * 1e3,
           'peak_allocated_gb': peak,
           'card_vs_cpu_features_4': {'max_abs_err': err, 'max_ref': scale,
                                      'tol': f'{P22_TOL} x max|ref|'},
           'fp32_tf32_off': True, 'card': SMI}
    emit(rec)


def _fid_value(lines):
    return float(lines[-1].split('fid:')[1])


def _fid_folder(root, rng, pool):
    """Futures of the PNG writes of the FID_N-image folder (8 x 8 random
    colour blocks an image)."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    folder = os.path.join(root, 'faces')
    futures = []
    for i in range(FID_N):
        base = rng.integers(0, 256, (8, 8, 3))
        img = np.kron(base, np.ones((FID_HW // 8, FID_HW // 8, 1)))
        futures.append(pool.submit(imwrite, img.astype(np.uint8),
                                   os.path.join(folder, f'{i:05d}.png')))
    return folder, futures


def _fid_stats_in_process(root, folder, pth, dev):
    """The statistics job's computation (``calculate_fid_stats_from_
    datasets``' FFHQDataset, batches and ``stats``) in this process, so the
    FID commands need not wait for the statistics command; its file."""
    from bsvd_tpu_torch.metrics.fid import (extract_inception_features,
                                            load_patched_inception_v3)
    from bsvd_tpu_torch.scripts.metrics import \
        calculate_fid_stats_from_datasets as fs
    dataset = build_dataset({
        'name': 'FFHQ', 'type': 'FFHQDataset', 'dataroot_gt': folder,
        'io_backend': {'type': 'disk'}, 'use_hflip': False,
        'mean': [0.5, 0.5, 0.5], 'std': [0.5, 0.5, 0.5]})
    net = load_patched_inception_v3(pretrain_path=pth, device=dev)
    # a command runs with PyTorch's default TF32 for cuDNN convs (this
    # script turns it off): the same here, so both compute alike
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mean, cov = fs.stats(extract_inception_features(fs.batches(
                dataset, 'gt', FID_N, INCEPTION_BATCH), net), FID_N)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    path = os.path.join(root, f'inception_FFHQ_{FID_HW}_in_process.npz')
    np.savez(path, name='FFHQ', size=FID_HW, mean=mean, cov=cov)
    return path


def _fid_jobs(root, folder, pth, dev):
    """The three FID scripts as commands, run at once: the statistics job,
    and against the same statistics computed in this process first, the
    folder's FID (the same images: about 0) and a random StyleGAN2 256
    Cmul2's FID. The command's statistics must equal this process's to
    1e-4 x max|ref|."""
    from bsvd_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
    from bsvd_tpu_torch.convert.torch_generic import to_jax_tree
    env = {'BSVD_INCEPTION_PRETRAIN_PATH': pth}
    stats = os.path.join(root, f'inception_FFHQ_{FID_HW}.npz')
    ref = _fid_stats_in_process(root, folder, pth, dev)

    def stats_ok(lines, rec):
        with np.load(stats) as z, np.load(ref) as r:
            rec['keys'] = sorted(z.files)
            rec['trace_cov'] = float(np.trace(z['cov']))
            rec['max_abs_diff_in_process'] = {
                k: float(np.abs(z[k] - r[k]).max()) for k in ('mean', 'cov')}
            close = all(rec['max_abs_diff_in_process'][k] <= P22_TOL *
                        np.abs(r[k]).max() for k in ('mean', 'cov'))
        return rec['keys'] == ['cov', 'mean', 'name', 'size'] and close

    def same_ok(lines, rec):
        rec['fid'] = _fid_value(lines)
        with np.load(ref) as z:
            trace = float(np.trace(z['cov']))
        return abs(rec['fid']) <= 1e-3 * trace

    def sg_ok(lines, rec):
        rec['fid'] = _fid_value(lines)
        return math.isfinite(rec['fid'])
    g = StyleGAN2Generator(256, num_style_feat=512, num_mlp=8,
                           channel_multiplier=2, seed=SEED)
    ckpt = os.path.join(root, 'stylegan2_256.npz')
    save_npz_params(ckpt, {'params_ema': to_jax_tree(g)})
    mod = 'bsvd_tpu_torch.scripts.metrics.'
    return [('fid_stats', [mod + 'calculate_fid_stats_from_datasets',
                           '--dataroot', folder, '--size', str(FID_HW),
                           '--num_sample', str(FID_N), '--device', dev],
             env, root, stats_ok),
            ('fid_folder_same_images',
             [mod + 'calculate_fid_folder', folder, '--fid_stats', ref,
              '--num_sample', str(FID_N), '--device', dev], env, ROOT,
             same_ok),
            ('fid_stylegan2_256_cmul2',
             [mod + 'calculate_stylegan2_fid', ckpt, ref, '--size', '256',
              '--num_sample', str(FID_N), '--device', dev], env, ROOT,
             sg_ok)]


def _lpips_files(root, seed):
    """Random torchvision-layout VGG16 weights (He-normal, through
    conv5_3) and lpips heads, as ``.pth`` files."""
    from bsvd_tpu_torch.archs.vgg_arch import vgg_names
    from bsvd_tpu_torch.metrics.lpips import CHNS
    gen = torch.Generator().manual_seed(seed)
    vgg, cin = {}, 3
    for idx, name in enumerate(vgg_names('vgg16')[:30]):
        if name.startswith('conv'):
            cout = min(64 * 2 ** (int(name[4]) - 1), 512)
            vgg[f'features.{idx}.weight'] = torch.randn(
                (cout, cin, 3, 3), generator=gen) * math.sqrt(2 / (9 * cin))
            vgg[f'features.{idx}.bias'] = (torch.rand(
                cout, generator=gen) - 0.5) * 0.2
            cin = cout
    lins = {f'lin{i}.model.1.weight': torch.rand((1, c, 1, 1), generator=gen)
            * 0.1 for i, c in enumerate(CHNS)}
    paths = (os.path.join(root, 'lpips_vgg.pth'),
             os.path.join(root, 'vgg16.pth'))
    torch.save(lins, paths[0])
    torch.save(vgg, paths[1])
    return paths


def _lpips(root, rng, pool, dev='cuda'):
    """LPIPS at 512 x 512 in-process: ms a pair, card against CPU on one
    pair; returns the ``calculate_lpips`` job on LPIPS_PAIRS PNG pairs
    (its per-pair lines and average)."""
    from bsvd_tpu_torch.metrics.lpips import load_lpips
    from bsvd_tpu_torch.utils.img_util import imwrite
    lin, vgg = _lpips_files(root, SEED + 103)
    gt, res = os.path.join(root, 'lp_gt'), os.path.join(root, 'lp_res')
    futures = []
    for i in range(LPIPS_PAIRS):
        base = rng.integers(0, 256, (LPIPS_HW // 8, LPIPS_HW // 8, 3))
        img = np.kron(base, np.ones((8, 8, 1)))
        noisy = np.clip(img + rng.normal(0, 10, img.shape), 0, 255)
        futures += [pool.submit(imwrite, img.astype(np.uint8),
                                os.path.join(gt, f'{i:03d}.png')),
                    pool.submit(imwrite, noisy.astype(np.uint8),
                                os.path.join(res, f'{i:03d}.png'))]
    net = load_lpips(lin, vgg, device=dev)
    pair = [torch.from_numpy(rng.uniform(-1, 1, (1, 3, LPIPS_HW, LPIPS_HW))
                             .astype(np.float32)) for _ in range(2)]
    card = [p.to(dev) for p in pair]
    torch.cuda.empty_cache()
    with torch.no_grad():
        got, ms, _ = _card_ms(lambda: net(*card), reps=10)
        peak = torch.cuda.max_memory_allocated() / 1e9
        ref = copy.deepcopy(net).cpu()(*pair)
    err, scale = _p22_close('lpips', got, ref)
    for f in futures:
        f.result()
    emit({'phase': 'lpips', 'hw': [LPIPS_HW] * 2, 'ms_per_pair': ms,
          'peak_allocated_gb': peak,
          'card_vs_cpu': {'max_abs_err': err, 'max_ref': scale,
                          'tol': f'{P22_TOL} x max|ref|'},
          'fp32_tf32_off': True, 'card': SMI})

    def check(lines, rec):
        vals = [float(line.split('LPIPS: ')[1].rstrip('.'))
                for line in lines if '. \tLPIPS' in line]
        rec['pairs'] = len(vals)
        rec['average'] = float(lines[-1].split('LPIPS: ')[1])
        return len(vals) == LPIPS_PAIRS and all(
            math.isfinite(v) and v > 0 for v in vals)
    return ('calculate_lpips',
            ['bsvd_tpu_torch.scripts.metrics.calculate_lpips', '--gt', gt,
             '--restored', res, '--device', dev],
            {'BSVD_LPIPS_PRETRAIN_PATH': lin,
             'BSVD_VGG16_PRETRAIN_PATH': vgg}, ROOT, check)


def _diffjpeg(rng, dev='cuda'):
    """DiffJPEG on Real-ESRGAN's batch, quality drawn from JPEG_Q: ms of
    the forward and of forward + backward; card against CPU: the
    quantised coefficients (``torch.round``) one step apart on at most
    1e-4 of them, and the decode of the CPU's coefficients on the card
    within P22_TOL x max|ref| of the CPU's."""
    from bsvd_tpu_torch.utils import diffjpeg
    x = torch.from_numpy(rng.uniform(0, 1, JPEG_SHAPE).astype(np.float32))
    q = torch.from_numpy(rng.uniform(*JPEG_Q, JPEG_SHAPE[0]).astype(
        np.float32))
    xc, qc = x.to(dev), q.to(dev)
    jpeg = diffjpeg.DiffJPEG(differentiable=True)
    with torch.no_grad():
        out, fwd_ms, _ = _card_ms(lambda: jpeg(xc, qc), reps=10)
    xg = xc.clone().requires_grad_(True)

    def fwd_bwd():
        xg.grad = None
        jpeg(xg, qc).sum().backward()
        return xg.grad
    grad, fb_ms, _ = _card_ms(fwd_bwd, reps=10)
    xh, xhc = x.permute(0, 2, 3, 1), xc.permute(0, 2, 3, 1)
    cpu_c = diffjpeg.compress(xh, q, torch.round)
    card_c = diffjpeg.compress(xhc, qc, torch.round)
    flips = total = 0
    for k in cpu_c:
        d = (card_c[k].cpu() - cpu_c[k]).abs()
        if d.max().item() > 1:
            raise AssertionError(f'diffjpeg {k}: coefficients {d.max()} '
                                 'steps apart')
        flips += int((d > 0).sum())
        total += d.numel()
    h, w = JPEG_SHAPE[2:]
    ref = diffjpeg.decompress(cpu_c, q, h, w)
    got = diffjpeg.decompress({k: v.to(dev) for k, v in cpu_c.items()}, qc,
                              h, w)
    err, scale = _p22_close('diffjpeg decode', got, ref)
    rec = {'phase': 'diffjpeg', 'shape': list(JPEG_SHAPE),
           'quality_range': list(JPEG_Q), 'fwd_ms': fwd_ms,
           'fwd_bwd_ms': fb_ms,
           'out_vs_cpu_max_abs_err': (out.cpu() - jpeg(x, q)).abs().max()
           .item(), 'coefficient_flips': flips, 'coefficients': total,
           'decode_card_vs_cpu': {'max_abs_err': err, 'max_ref': scale},
           'grad_finite': bool(torch.isfinite(grad).all()), 'card': SMI}
    emit(rec)
    if flips > 1e-4 * total or not rec['grad_finite']:
        raise AssertionError(f'DiffJPEG: {rec}')


def phase_swinir_fid_lpips_diffjpeg(dev='cuda'):
    """Phase 22: SwinIR, FID, LPIPS, DiffJPEG. No kernel of the port is on
    these paths (plain PyTorch, as the JAX package's XLA): the phase must
    add no launch to the kernels line. The in-process timings come first;
    then the five commands in two waves of concurrent processes (their
    seconds are those of a shared card and host)."""
    t0 = time.perf_counter()
    before = counts()
    root = os.path.join(WORK, 'swinir_fid')
    rng = np.random.default_rng(SEED + 100)
    with ThreadPoolExecutor(8) as pool:
        writes = _swinir_pairs(root, rng, pool)
        folder, fid_writes = _fid_folder(root, rng, pool)
        net = _swinir_forward(rng, dev)
        for f in writes:
            f.result()
        _swinir_cli(root, dev)
        inference = _swinir_inference_job(root, net, rng, dev)
        del net
        torch.cuda.empty_cache()
        pth = _inception_pth(os.path.join(root, 'pt_inception.pth'),
                             SEED + 104)
        _inception(pth, rng, dev)
        lpips_job = _lpips(root, rng, pool, dev)
        for f in fid_writes:
            f.result()
    _diffjpeg(rng, dev)
    t1 = time.perf_counter()
    fid = _fid_jobs(root, folder, pth, dev)
    t_fid = time.perf_counter() - t1
    t1 = time.perf_counter()
    commands = _run_jobs([inference, lpips_job, *fid])
    emit({'phase': 'swinir_fid_lpips_commands', 'waves': [
        ['inference_swinir', 'calculate_lpips', 'fid_stats',
         'fid_folder_same_images', 'fid_stylegan2_256_cmul2']],
          'fid_stats_in_process_s': t_fid,
        'fid_images': FID_N, 'fid_hw': [FID_HW] * 2,
        'lpips_pairs': LPIPS_PAIRS, **commands,
        'wall_s': time.perf_counter() - t1, 'card': SMI})
    added = delta_since(before)
    emit({'phase': 'swinir_fid_lpips_diffjpeg',
          'seconds': time.perf_counter() - t0, 'launches_added': added})
    if any(added.values()):
        raise AssertionError(f'phase 22 launched kernels: {added}')

# ---------------------------------------------------------------------------
# phase 23: the zoo's storage and last scripts (lmdb stores made by the
# data scripts, the SR train CLI and Vimeo90K from them, the checkpoint
# converter's round trip on the kernels)
# ---------------------------------------------------------------------------

# BasicSR's DIV2K preparation (docs/DatasetPreparation.md): HR frames of
# 2040 wide, mod-12 GT and MATLAB-bicubic x4 LR, sub-images of 480 / 240
# (HR) and 120 / 60 (LR), then an lmdb store of each
DIV2K_HW, DIV2K_N, P23_ITERS = (1356, 2040), 2, 20
# Vimeo90K's septuplets are 448 x 256
VIMEO_SEQS, VIMEO_HW = ('00001/0001', '00001/0002', '00002/0001',
                        '00002/0007'), (256, 448)
SR_YML = os.path.join(ROOT, 'options', 'train', 'msrresnet_x4.yml')
P23_SCRIPTS = 'bsvd_tpu_torch.scripts'


def _p23_frame(rng, h, w):
    """A smooth colour field with texture (a coarse grid upscaled on the
    card, noise), uint8 BGR."""
    base = torch.from_numpy(rng.uniform(0, 255, (3, h // 24 + 2,
                                                 w // 24 + 2)))
    img = F.interpolate(base[None].cuda(), size=(h, w), mode='bilinear',
                        align_corners=False)[0].permute(1, 2, 0).cpu().numpy()
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).round().astype(
        np.uint8)


def _store_bytes(path):
    return os.path.getsize(os.path.join(path, 'data.mdb'))


class _FirstStep:
    """While SR train pipelines run: each run's first batch (CPU copies)
    and its first step's loss."""

    def __enter__(self):
        from bsvd_tpu_torch.models.sr_model import SRModel
        self.cls, self.runs = SRModel, []
        self.feed, self.step = SRModel.feed_data, SRModel.optimize_parameters
        first = self

        def feed(model, data):
            if not first.runs or first.runs[-1][0] is not model:
                first.runs.append([model, {k: torch.as_tensor(data[k]).cpu()
                                           .clone() for k in ('lq', 'gt')},
                                   None])
            return first.feed(model, data)

        def step(model, it):
            out = first.step(model, it)
            if first.runs[-1][2] is None:
                first.runs[-1][2] = float(model.get_current_log()['l_pix'])
            return out
        SRModel.feed_data, SRModel.optimize_parameters = feed, step
        return self

    def __exit__(self, *exc):
        self.cls.feed_data, self.cls.optimize_parameters = \
            self.feed, self.step


def _p23_sr_data(root):
    """The HR PNGs (``DIV2K_N`` of ``DIV2K_HW``, zlib level 1) and the
    folders the scripts make from them."""
    hr = os.path.join(root, 'DIV2K_train_HR')
    t0 = time.perf_counter()
    for i in range(DIV2K_N):
        _p23_png(_p23_frame(np.random.default_rng(SEED + 233 + i),
                               *DIV2K_HW),
                    os.path.join(hr, f'{i + 1:04d}.png'))
    d = {k: os.path.join(root, k) for k in (
        'GTmod12', 'LRbicx4', 'GT_sub', 'LR_sub')}
    d['gt_lmdb'] = os.path.join(root, 'DIV2K_train_HR_sub.lmdb')
    d['lq_lmdb'] = os.path.join(root, 'DIV2K_train_LR_bicubic_X4_sub.lmdb')
    d['meta'] = os.path.join(root, 'meta_info_DIV2K_sub_GT.txt')
    return d, time.perf_counter() - t0


def _p23_png(img, path):
    from bsvd_tpu_torch.utils.img_util import IMWRITE_PNG_COMPRESSION, imwrite
    imwrite(img, path, [IMWRITE_PNG_COMPRESSION, 1])


def _p23_vimeo(root, rng):
    """The GT septuplet tree (``VIMEO_SEQS`` of 7 frames), its meta-info
    file, the LQ tree and store paths the scripts make."""
    gt = os.path.join(root, 'vimeo_septuplet', 'sequences')
    for seq in VIMEO_SEQS:
        for i in range(1, 8):
            _p23_png(_p23_frame(rng, *VIMEO_HW),
                        os.path.join(gt, seq, f'im{i}.png'))
    meta = os.path.join(root, 'meta_info_Vimeo90K_test.txt')
    with open(meta, 'w') as f:
        f.writelines(f'{s} 7 ({VIMEO_HW[0]},{VIMEO_HW[1]},3)\n'
                     for s in VIMEO_SEQS)
    lq = os.path.join(root, 'vimeo_septuplet_matlabLRx4', 'sequences')
    return {'gt': gt, 'lq': lq, 'meta': meta,
            'gt_lmdb': os.path.join(root, 'vimeo90k_train_GT_only4th.lmdb'),
            'lq_lmdb': os.path.join(root, 'vimeo90k_train_LR7frames.lmdb')}


def _p23_scripts(root, d, v, pth, npz):
    """The scripts by their ``main(argv)`` in this process (what ``python
    -m`` runs, without a process start each): the two MATLAB scripts on
    the card and the converter, then the host-only data scripts in two
    dependent waves of threads."""
    from bsvd_tpu_torch.scripts.data_preparation import (create_lmdb,
                                                         extract_subimages,
                                                         generate_meta_info)
    t0 = time.perf_counter()
    out = {'main_s': {name: _run_main(f'{P23_SCRIPTS}.{mod}', argv)
                      for name, mod, argv in (
        ('generate_bicubic_img', 'matlab_scripts.generate_bicubic_img', [
            '--input', os.path.join(root, 'DIV2K_train_HR'), '--mod_scale',
            '12', '--up_scale', '4', '--save_mod', d['GTmod12'], '--save_lr',
            d['LRbicx4'], '--device', 'cuda']),
        ('generate_LR_Vimeo90K', 'matlab_scripts.generate_LR_Vimeo90K', [
            '--root', os.path.dirname(v['gt']), '--device', 'cuda']),
        ('convert_to_npz_tsn', 'model_conversion.convert_to_npz', [
            '--tsn', '--input', pth, '--output', npz]))}}
    if not (len(os.listdir(d['LRbicx4'])) == DIV2K_N and os.path.exists(npz)
            and len(os.listdir(os.path.join(v['lq'], VIMEO_SEQS[0]))) == 7):
        raise AssertionError(f'phase 23 scripts: {os.listdir(root)}')
    waves = [
        {'extract_subimages_hr': (extract_subimages, [
            '--input', d['GTmod12'], '--output', d['GT_sub'], '--crop_size',
            '480', '--step', '240']),
         'extract_subimages_lr': (extract_subimages, [
             '--input', d['LRbicx4'], '--output', d['LR_sub'],
             '--crop_size', '120', '--step', '60']),
         'create_lmdb_vimeo_gt': (create_lmdb, [
             '--input', v['gt'], '--output', v['gt_lmdb']]),
         'create_lmdb_vimeo_lq': (create_lmdb, [
             '--input', v['lq'], '--output', v['lq_lmdb']])},
        {'generate_meta_info': (generate_meta_info, [
            '--input', d['GT_sub'], '--meta_info', d['meta']]),
         'create_lmdb_div2k_hr': (create_lmdb, [
             '--input', d['GT_sub'], '--output', d['gt_lmdb']]),
         'create_lmdb_div2k_lr': (create_lmdb, [
             '--input', d['LR_sub'], '--output', d['lq_lmdb']])}]

    def run(item):
        name, (mod, argv) = item
        t = time.perf_counter()
        mod.main(argv)
        return name, time.perf_counter() - t
    # their progress lines are not this script's: stdout is set aside
    # around the waves (not in each thread: the swap is global)
    with contextlib.redirect_stdout(io.StringIO()):
        for wave in waves:
            with ThreadPoolExecutor(len(wave)) as pool:
                out['main_s'].update(pool.map(run, wave.items()))
    out['wall_s'] = time.perf_counter() - t0
    for folder in (d['GT_sub'], d['LR_sub']):
        if len(os.listdir(folder)) != 40 * DIV2K_N:
            raise AssertionError(f'extract_subimages: {folder}')
    return out


def _p23_sr_yml(root, d):
    """options/train/msrresnet_x4.yml copied line by line, with
    ``io_backend: {type: lmdb}`` and the stores as its train and val
    data."""
    lines = []
    with open(SR_YML) as f:
        for line in f:
            key = line.strip().split(':')[0]
            pad = line[:len(line) - len(line.lstrip())]
            if key in ('dataroot_gt', 'dataroot_lq'):
                line = f"{pad}{key}: {d[key[-2:] + '_lmdb']}\n"
            lines.append(line)
            if line.strip() == 'type: PairedImageDataset':
                lines += [f'{pad}io_backend:\n', f'{pad}  type: lmdb\n']
    path = os.path.join(root, 'msrresnet_x4_lmdb.yml')
    with open(path, 'w') as f:
        f.writelines(lines)
    opt = yaml_load(path)
    if not all(opt['datasets'][ph]['io_backend'] == {'type': 'lmdb'}
               and opt['datasets'][ph]['dataroot_gt'] == d['gt_lmdb']
               for ph in ('train', 'val')):
        raise AssertionError(f'lmdb yml: {opt["datasets"]}')
    return path


def _p23_sr_cli(root, d):
    """The SR train CLI on the lmdb yml, then on the sub-image folders:
    their first batches bit-equal, their first losses within 1e-6."""
    yml = _p23_sr_yml(root, d)
    force = [f'train:total_iter={P23_ITERS}', 'logger:print_freq=10']
    disk = [f'datasets:{ph}:{k}' for ph in ('train', 'val') for k in (
        'io_backend:type=disk', f"dataroot_gt={d['GT_sub']}",
        f"dataroot_lq={d['LR_sub']}")]
    runs = {}
    from bsvd_tpu_torch.models.sr_model import SRModel
    with _FirstStep() as first:
        for name, extra in (('lmdb', []), ('folders', disk)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _StepClock((SRModel,)) as clock:
                model = train_pipeline(os.path.join(root, name), cmd=[
                    '-opt', yml, '--force_yml', *force, *extra])
            torch.cuda.synchronize()
            steady = clock.steady(6, P23_ITERS)
            runs[name] = {
                'wall_s': time.perf_counter() - t0, 'steady': steady,
                'wait_share': steady['data_wait_ms'] / steady['ms_per_iter'],
                'iters': model.optimizer.count,
                'loss_last': float(model.get_current_log()['l_pix'])}
    (_, b_lmdb, l_lmdb), (_, b_disk, l_disk) = first.runs[:2]
    same = {k: bool(torch.equal(b_lmdb[k], b_disk[k])) for k in ('lq', 'gt')}
    rel = abs(l_lmdb - l_disk) / abs(l_disk)
    rec = {'yml': os.path.relpath(SR_YML, ROOT), 'runs': runs,
           'first_batch_shapes': {k: list(v.shape)
                                  for k, v in b_lmdb.items()},
           'first_batches_bit_equal': same, 'first_losses': [l_lmdb, l_disk],
           'first_loss_rel_diff': rel}
    if not (all(same.values()) and rel <= 1e-6
            and all(r['iters'] == P23_ITERS and math.isfinite(r['loss_last'])
                    for r in runs.values())):
        raise AssertionError(f'lmdb SR train CLI: {rec}')
    return rec


def _p23_vimeo_items(v):
    """Vimeo90KDataset and Vimeo90KRecurrentDataset items from the stores
    equal to the items from the folders, every sequence."""
    out = {}
    for kind in ('Vimeo90KDataset', 'Vimeo90KRecurrentDataset'):
        opt = {'name': 'vimeo', 'type': kind, 'num_frame': 7,
               'random_reverse': True, 'meta_info_file': v['meta'],
               'gt_size': 256, 'scale': 4, 'manual_seed': SEED,
               'phase': 'train'}
        lm = build_dataset(dict(opt, dataroot_gt=v['gt_lmdb'],
                                dataroot_lq=v['lq_lmdb'],
                                io_backend={'type': 'lmdb'}))
        fo = build_dataset(dict(opt, dataroot_gt=v['gt'], dataroot_lq=v['lq'],
                                io_backend={'type': 'disk'}))
        t0 = time.perf_counter()
        items = [lm[i] for i in range(len(lm))]
        lmdb_s = time.perf_counter() - t0
        equal = [all(np.array_equal(a[k], b[k]) for k in ('lq', 'gt'))
                 and a['key'] == b['key']
                 for a, b in zip(items, (fo[i] for i in range(len(fo))))]
        out[kind] = {'items': len(items), 'bit_equal': equal,
                     'lq': list(items[0]['lq'].shape),
                     'gt': list(items[0]['gt'].shape),
                     'lmdb_ms_per_item': lmdb_s / len(items) * 1e3}
        if not (len(items) == len(VIMEO_SEQS) and all(equal)):
            raise AssertionError(f'Vimeo90K on lmdb: {kind} {out[kind]}')
    return out


def _p23_tsn_pth(path):
    """A c64 TSN checkpoint of random weights (the test yml's network_g)
    in the reference's layout; the net it came from."""
    from bsvd_tpu_torch.archs.wnet_arch import _to_tree
    from bsvd_tpu_torch.convert.torch_ckpt import to_tsn_state_dict
    net = build_network(dict(C64, seed=SEED + 231), 'cpu')
    torch.save({'params': to_tsn_state_dict(_to_tree(net.params), net.cfg)},
               path)


def _p23_round_trip(pth, npz, clip):
    """The net loaded from the .pth and the net built from convert_to_npz's
    .npz: a 10-frame 540p bf16 whole-clip forward each on K1-K4, bit-equal.
    Returns the launches."""
    from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params
    from bsvd_tpu_torch.models.checkpoint import load_npz_params
    a = build_network(C64)
    a.load(pth)
    b = build_network(C64)
    b.load_params(from_jax_params(load_npz_params(npz), b.cfg))
    reset_counts()
    outs = []
    with _NoConv2d():
        for net in (a, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(denoise_seq(net, None, clip[1], noise_sigma=SIGMA,
                                    compute_dtype=torch.bfloat16))
            wall = time.perf_counter() - t0
    launches = counts()
    for k in KERNELS:
        if launches[k] != 2 * PER_FORWARD.get(k, 0):
            raise AssertionError(f'npz round trip: {k} launched '
                                 f'{launches[k]}, expected '
                                 f'{2 * PER_FORWARD.get(k, 0)}')
    _check_out(outs[0], clip[0])
    rec = {'forward': [T, H, W], 'dtype': 'bfloat16',
           'outputs_bit_equal': bool(np.array_equal(outs[0], outs[1])),
           'npz_keys': len(np.load(npz).files),
           'denoise_seq_s': wall, 'launches': launches}
    if not rec['outputs_bit_equal']:
        raise AssertionError(f'npz round trip: outputs differ {rec}')
    return rec, launches


def phase_storage_scripts():
    """Phase 23: the data scripts make lmdb stores as BasicSR documents
    for DIV2K and Vimeo90K; the SR train CLI and the Vimeo90K datasets
    read them; convert_to_npz's checkpoint drives K1-K4. Memcached and the
    downloads need a server: they are held on the CPU only. Returns the
    launches."""
    t0 = time.perf_counter()
    root = os.path.join(WORK, 'storage')
    rng = np.random.default_rng(SEED + 230)
    d, hr_s = _p23_sr_data(root)
    v = _p23_vimeo(root, rng)
    pth, npz = os.path.join(root, 'bsvd-64.pth'), os.path.join(
        root, 'bsvd-64.npz')
    _p23_tsn_pth(pth)
    data_s = time.perf_counter() - t0
    scripts = _p23_scripts(root, d, v, pth, npz)
    with open(d['meta']) as f:
        meta = f.read().splitlines()
    keys = data_util.paths_from_lmdb(d['gt_lmdb'])
    if not (len(meta) == 40 * DIV2K_N and meta[0] == '0001_s001.png '
            '(480,480,3)' and keys == [m.split('.')[0] for m in meta]
            and data_util.paths_from_lmdb(v['lq_lmdb'])[0]
            == f'{VIMEO_SEQS[0]}/im1'):
        raise AssertionError(f'phase 23 stores: {meta[:2]} {keys[:2]}')
    stores = {os.path.basename(p): _store_bytes(p) for p in (
        d['gt_lmdb'], d['lq_lmdb'], v['gt_lmdb'], v['lq_lmdb'])}
    emit({'phase': 'storage_scripts', 'hr': [DIV2K_N, *DIV2K_HW],
          'write_s': data_s, 'hr_write_s': hr_s, 'scripts': scripts,
          'sub_images': len(meta), 'store_bytes': stores,
          'store': 'record log (no lmdb package)'
          if lmdb_util.lmdb_package().__name__.endswith('_lmdb_compat')
          else 'lmdb package', 'card': SMI})
    emit(dict(_p23_sr_cli(root, d), phase='storage_sr_train_cli',
              card=SMI))
    emit({'phase': 'storage_vimeo90k', 'sequences': len(VIMEO_SEQS),
          'gt_hw': VIMEO_HW, **_p23_vimeo_items(v)})
    clip = _clips(np.random.default_rng(SEED + 232), 1)[0]
    rec, launches = _p23_round_trip(pth, npz, clip)
    emit(dict(rec, phase='storage_npz_round_trip', card=SMI))
    emit({'phase': 'storage', 'seconds': time.perf_counter() - t0,
          'cpu_only': 'memcached and the downloads need a server: '
                      'tests/test_torch_io_utils.py on the CPU'})
    return launches


def main():
    global WORK
    if sys.argv[1:2] == ['--train-cli-rank']:
        train_cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:])
        return
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available()'
                         ' is False); this script runs only on a GPU')
    WORK = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        run()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def timed(name, fn, *args):
    """``fn(*args)``, its seconds kept under ``name`` in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    return out


def run():
    global SMI, T_START
    T_START = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True, check=True).stdout
    emit({'phase': 'device', 'name': name, 'count': torch.cuda.device_count(),
          'torch': torch.__version__, 'cuda': torch.version.cuda})
    print(smi.strip(), flush=True)
    SMI = smi.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # the data path's g++ libraries build beside the kernels' nvcc runs
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        helpers = {name: pool.submit(mod.build) for name, mod in (
            ('png_unfilter', png_decode), ('jpeg_decode', jpeg_decode),
            ('jpeg_encode', jpeg_encode), ('nvdec', nvdec),
            ('tiff_decode', tiff_decode))}
        lib_path = _build.build()
        _build.lib()
        t1 = time.perf_counter()
        helpers = {k: f.result() for k, f in helpers.items()}
    for mod in (png_decode, jpeg_decode, jpeg_encode, nvdec, tiff_decode):
        mod.lib()
    emit({'phase': 'build', 'seconds': t1 - t0,
          'library': os.path.relpath(lib_path, ROOT),
          'with_data_helpers_seconds': time.perf_counter() - t0,
          'data_helper_libraries': {k: os.path.relpath(v, ROOT)
                                    for k, v in helpers.items()}})

    summary = timed('2_kernels', phase_kernels)
    clips = _clips(np.random.default_rng(SEED), 3)
    nets, outs, launches = timed('3_main', phase_main, clips)
    out32 = timed('4_parity', phase_parity, nets, clips, outs)
    clip24 = _clips(np.random.default_rng(SEED + 3), 1, STREAM_T)[0]
    stream_launches = timed('5_stream', phase_stream, nets, clip24)
    seq_launches, off_path = timed('6_stream_parity', phase_stream_parity,
                                   nets, clips, outs, out32)
    # K6 is off the streaming main path when every MemCvBlock takes K5
    off_route = () if k6_on_path() else ('bibuffer_chain',)
    for k in KERNELS:
        if (k not in NOT_STREAMED + off_route
                and not stream_launches[k] > 0):
            raise AssertionError(f'{k} never launched on the streaming path')
        launches[k] += stream_launches[k] + seq_launches[k]
    _sum_launches(launches, timed('6a_over_budget', phase_over_budget,
                                  nets, clips, outs, out32))
    timed('7_train_grad', phase_train_grad)
    train_launches = timed('8_train', phase_train)
    chunk_launches = timed('9_chunked', phase_chunked, nets)
    data = timed('12_frames', phase_frames)
    jdata = timed('12a_jpeg_frames', phase_jpeg_frames, data)
    eval_launches = timed('10_eval', phase_eval, nets, data)
    jpeg_eval_launches = timed('10_eval_jpeg', phase_eval, nets, jdata,
                               False)
    option_launches_run = timed('11_options', phase_options, nets, clip24)
    entry_launches = timed('12_entry', phase_entry, data)
    jpeg_train_launches = timed('12a_train_cli_jpeg', phase_train_cli_jpeg,
                                jdata)
    parallel_launches = timed('13_streams', phase_streams, nets['TSM'],
                              clip24)
    timed('13_loader_draws', phase_loader_draws)
    _sum_launches(parallel_launches, timed('13_dryrun',
                                           phase_parallel_dryrun))
    _sum_launches(parallel_launches, timed('13_nccl_train_cli',
                                           phase_nccl_train_cli, data))
    _sum_launches(parallel_launches, timed('14_profile', phase_profile,
                                           nets['TSM']))
    _sum_launches(parallel_launches, timed('15_zoo_sr', phase_zoo_sr))
    mp4_launches, nv12_rgb = timed('16_mp4', phase_mp4, data)
    _sum_launches(parallel_launches, mp4_launches)
    timed('17_zoo_vsr', phase_zoo_vsr)
    _sum_launches(parallel_launches, timed('18_tools', phase_tools))
    timed('19_face_gans', phase_face_gans)
    timed('20_video_family', phase_video_family)
    timed('21_faces_degradations', phase_faces_degradations)
    timed('22_swinir_fid_lpips_diffjpeg', phase_swinir_fid_lpips_diffjpeg)
    _sum_launches(parallel_launches, timed('23_storage_scripts',
                                           phase_storage_scripts))
    emit({'phase': 'phase_seconds', 'seconds': PHASE_S,
          'total_s': time.perf_counter() - T_START})
    for k in KERNELS:
        launches[k] += (train_launches[k] + chunk_launches[k]
                        + eval_launches[k] + jpeg_eval_launches[k]
                        + option_launches_run[k] + entry_launches[k]
                        + jpeg_train_launches[k] + parallel_launches[k])
        if k not in off_route and not launches[k] > 0:
            raise AssertionError(f'{k} never launched on a main path')
        if k in off_route and launches[k]:
            raise AssertionError(f'{k} launched on a main path off its route')
    per = {k: v[3] for k, v in KERNELS.items()}
    for k in off_route:
        per[k] = 'one launch at each bidirectional site (off the main path)'

    emit({'kernels': [
        {'name': k, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[k], 'max_abs_err': summary[k]['max_abs_err'],
         'ms': summary[k]['ms'], 'plain_ms': summary[k]['plain_ms'],
         'bound_ms': summary[k]['bound_ms'],
         'bound_by': summary[k]['bound_by'],
         'library_ms': summary[k]['library_ms'],
         'library_pair_ms': summary[k]['library_pair_ms'], 'per': per[k],
         'off_path_launches': off_path[k]}
        for k, (_, src, rep, _) in KERNELS.items()] + [
        {k: nv12_rgb[k] for k in (
            'name', 'source', 'replaces', 'launches', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'per',
            'main_path')}
        | {'route': 'cuda', 'library_pair_ms': None,
           'off_path_launches': 0}]})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
