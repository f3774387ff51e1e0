"""Command line of the port: ``python -m sincformer_tpu_torch.cli <verb>``.

  * ``demo`` - the oracle masks (IRM, PCIRM, OPT-PCIRM) of a synthetic 2 s
    signal at 0, 5 and 10 dB SNR, the scalar-gain reconstruction, the five
    metrics and the mask statistics; no data or model needed;
  * ``enhance`` - enhance WAV file(s) with a trained model (the flagship,
    DCSE, or a mask DNN of the original paper: ``--model pcirm``,
    ``opt_pcirm``, ``irm``): long files through the streaming enhancer, many
    files batched, ``--online`` through the causal online enhancer (several
    inputs: the batched pool);
  * ``export`` - write a trained checkpoint family as a compact int8
    serving artifact (a drop-in model directory); ``--model dnn
    --mask-type`` for a mask DNN;
  * ``train`` - train on TIMIT + NOISEX-92, or on ``--synthetic N``
    synthetic utterances (no dataset needed): ``--pipeline dnn`` (the
    default) the original paper's mask DNN (``--mask-type``, ``--no-rbm``),
    ``--pipeline conformer`` (alias ``dcse``) DCSE, ``--pipeline agents``
    the flagship's curriculum (``--adversarial`` adds the stage-3
    discriminator, ``--pa reference`` the stride-2 cascade PerceptionAgent,
    ``--cpea ssm`` the bidirectional LRU mixer); ``--resume`` continues from
    the newest checkpoint, ``--log-jsonl`` writes one record per epoch;
  * ``evaluate`` (alias ``test``) - the five-metric grid (STOI, PESQ,
    SSNR, CSII, NCM) over every trained model found (a reference
    ``conformer_final.pt`` included), on TIMIT + NOISEX-92 or the synthetic
    fallbacks; ``--json-out`` writes every cell; ``--mesh`` splits the
    metric sweep over every visible card, ``--distributed`` deals the
    (noise, SNR) cells to the processes that ``torchrun`` starts;
  * ``calibrate`` - fit the output gain of a trained checkpoint on
    held-out mixtures and persist it in its sidecar;
  * ``info`` - print the configuration, the device and the flagship
    checkpoints under the model directory with their variants.

Models are looked up and written under ``SINCFORMER_MODEL_DIR`` (default
``saved_models``), as in the JAX package's CLI; a flagship checkpoint of any
variant is served as its weights show. Everything runs on the card unless
``--device cpu`` is given. Every verb of the JAX package's CLI is ported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_MISSING = ""          # what of the JAX package's CLI is not ported


def _model_dir() -> str:
    return os.environ.get("SINCFORMER_MODEL_DIR", "saved_models")


_MASK_TYPES = ("pcirm", "opt_pcirm", "irm")
# preference order of ``enhance``: flagship, DCSE, then the mask DNNs
_MODELS = ("sincformer", "conformer") + _MASK_TYPES


def _family(model: str):
    """(constructor taking ``device`` and ``model_dir``, final checkpoint
    family, best-validation family) of ``model`` (a name of _MODELS)."""
    import functools

    from sincformer_tpu_torch.pipeline import (DCSEPipeline, DNNPipeline,
                                               SincformerPipeline)
    if model in _MASK_TYPES:
        return (functools.partial(DNNPipeline, mask_type=model),
                f"dnn_{model}_final", f"best_{model}")
    cls = {"sincformer": SincformerPipeline, "conformer": DCSEPipeline}[model]
    return cls, cls.FINAL_NAME, cls.BEST_NAME


def _load_pipeline(prefer, device):
    """The first family of _MODELS with a checkpoint under the model
    directory, loaded; (None, None) when there is none."""
    model_dir = _model_dir()
    for cand in ([prefer] if prefer else _MODELS):
        make, final_name, best_name = _family(cand)
        if not any(os.path.isdir(os.path.join(model_dir, name))
                   for name in (final_name, best_name)):
            print(f"  x {cand}: no {final_name} or {best_name} under "
                  f"{model_dir}")
            continue
        pipe = make(device=device, model_dir=model_dir)
        pipe.load_model()
        return cand, pipe
    return None, None


def enhance(args) -> int:
    """Enhance WAV file(s) with the best available trained model."""
    from scipy.io import wavfile

    from sincformer_tpu_torch.config import AudioConfig
    from sincformer_tpu_torch.data.audio import load_audio
    from sincformer_tpu_torch.serve import (OnlineEnhancer,
                                            OnlineEnhancerPool,
                                            StreamingEnhancer)

    fs = AudioConfig().sample_rate
    name, pipe = _load_pipeline(args.model, args.device)
    if pipe is None:
        print("  No trained models found - train or export one first.")
        return 1
    print(f"  Using model: {name} on {pipe.device}")
    inputs = list(args.input)
    pcm16 = bool(args.pcm16)

    def towav(x):
        if x.dtype == np.int16:        # quantized on the device (serve.py)
            return x
        if pcm16:
            return StreamingEnhancer._quantize_host(x)
        return np.clip(x, -1.0, 1.0).astype(np.float32)

    if args.online:
        # live arrival simulated in 20 ms chunks; several inputs run as
        # concurrent streams, one batched forward pass per step for all
        if len(inputs) == 1:
            noisy = load_audio(inputs[0], fs)
            oe = OnlineEnhancer(pipe)
            print(f"  Online mode: {oe.latency_samples / fs * 1000:.0f} ms "
                  f"algorithmic latency, {oe.chunk / fs * 1000:.0f} ms "
                  f"chunks")
            t0 = time.time()
            parts = [oe.push(noisy[i:i + oe.chunk])
                     for i in range(0, len(noisy), oe.chunk)]
            parts.append(oe.flush())
            dt = time.time() - t0
            wavfile.write(args.output, fs, towav(np.concatenate(parts)))
            print(f"  Enhanced -> {args.output}  ({dt:.2f}s wall, "
                  f"{len(noisy) / fs / max(dt, 1e-9):.1f}x realtime)")
            return 0
        signals = [load_audio(p, fs) for p in inputs]
        pool = OnlineEnhancerPool(pipe, n_streams=len(signals))
        total_s = sum(len(s) for s in signals) / fs
        print(f"  Online pool: {len(signals)} concurrent streams, "
              f"{pool.latency_samples / fs * 1000:.0f} ms algorithmic "
              f"latency, one forward pass per "
              f"{pool.chunk / fs * 1000:.0f} ms step")
        os.makedirs(args.output, exist_ok=True)
        t0 = time.time()
        pos, n = [0] * len(signals), pool.chunk
        while any(p < len(s) for p, s in zip(pos, signals)):
            for i, s in enumerate(signals):       # lockstep arrival
                if pos[i] < len(s):
                    pool.push(i, s[pos[i]:pos[i] + n])
                    pos[i] += n
            pool.step()
        outs = [np.concatenate([pool.take(i), pool.flush(i)])
                for i in range(len(signals))]
        dt = time.time() - t0
        for base, out in zip(_output_names(inputs), outs):
            wavfile.write(os.path.join(args.output, base), fs, towav(out))
        print(f"  Enhanced {len(inputs)} streams -> {args.output}/  "
              f"({dt:.2f}s wall, {total_s / max(dt, 1e-9):.1f}x realtime "
              f"aggregate)")
        return 0

    se = StreamingEnhancer(pipe)
    if len(inputs) == 1:
        noisy = load_audio(inputs[0], fs)
        print(f"  Input: {inputs[0]} ({len(noisy) / fs:.2f}s @ {fs} Hz)")
        t0 = time.time()
        enhanced = se.enhance(noisy, pcm16_out=pcm16)
        dt = time.time() - t0
        wavfile.write(args.output, fs, towav(enhanced))
        print(f"  Enhanced -> {args.output}  ({dt:.2f}s wall, "
              f"{len(noisy) / fs / max(dt, 1e-9):.1f}x realtime)")
        return 0

    # many files: groups of one padded length share a forward pass
    os.makedirs(args.output, exist_ok=True)
    signals = [load_audio(p, fs) for p in inputs]
    total_s = sum(len(s) for s in signals) / fs
    print(f"  Inputs: {len(inputs)} files, {total_s:.2f}s total")
    t0 = time.time()
    outs = se.enhance_many(signals)
    dt = time.time() - t0
    for base, out in zip(_output_names(inputs), outs):
        wavfile.write(os.path.join(args.output, base), fs, towav(out))
    print(f"  Enhanced {len(inputs)} files -> {args.output}/  "
          f"({dt:.2f}s wall, {total_s / max(dt, 1e-9):.1f}x realtime)")
    return 0


def _output_names(inputs):
    """Base names of the inputs, made distinct: two inputs of one base name
    in different directories must not overwrite each other."""
    names, seen = [], {}
    for path in inputs:
        base = os.path.basename(path)
        if base in seen:
            seen[base] += 1
            stem, ext = os.path.splitext(base)
            base = f"{stem}_{seen[base]}{ext}"
        else:
            seen[base] = 0
        names.append(base)
    return names


def export(args) -> int:
    """Export a trained checkpoint family as an int8 serving artifact
    (``train/state.py::save_checkpoint_quantized``: int8 per output channel
    with stochastic rounding, about four times smaller). The exported
    directory is a drop-in model directory: point ``SINCFORMER_MODEL_DIR``
    at it. It is written under the final family's name whatever the source
    was; the sidecar records where it came from."""
    from sincformer_tpu_torch.train.state import merge_train_meta

    os.environ["SINCFORMER_CKPT_PREF"] = args.ckpt
    make, final_name, _ = _family(args.mask_type if args.model == "dnn"
                                  else args.model)
    pipe = make(device=args.device, model_dir=_model_dir())
    src = pipe.load_model()
    src_fam = os.path.dirname(os.path.abspath(src))
    out_dir = args.out or (pipe.model_dir.rstrip("/\\") + "_serving")
    os.makedirs(out_dir, exist_ok=True)
    pipe.model_dir = out_dir
    path = pipe.save_model(name=final_name, quantize=True)
    merge_train_meta(out_dir, final_name, {
        "exported_from": os.path.abspath(src),
        "source_step": int(pipe.step),
        "source_ckpt_pref": args.ckpt,
    })

    def du(d):
        return sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs) / 1e6
    print(f"  Source:   {src}  ({du(src_fam):.1f} MB family)")
    print(f"  Exported: {path}  ({du(out_dir):.1f} MB, int8 serving "
          f"artifact, output_gain={getattr(pipe, 'output_gain', 1.0):.4f})")
    print(f"  Load with: SINCFORMER_MODEL_DIR={out_dir}")
    return 0


def _synthetic_corpus(n: int, noise_kind: str = "white",
                      speech_kind: str = "formant"):
    """n synthetic clean utterances of 1-2 s and a noise bank, from fixed
    seeds: the JAX package's corpus for dataset-free training, bit for bit.
    ``noise_kind="multi"``: the 4-class synthetic noise bank (babble, white,
    factory1, destroyerengine) instead of one white noise;
    ``speech_kind="varied"``: a distinct randomized utterance per index
    instead of the fixed formant pattern."""
    from sincformer_tpu_torch.config import AudioConfig
    from sincformer_tpu_torch.data.synthetic import (synthetic_noise,
                                                     synthetic_noise_bank,
                                                     synthetic_speech,
                                                     synthetic_speech_varied)
    rng = np.random.default_rng(42)
    if speech_kind == "varied":
        clean = [synthetic_speech_varied(1.0 + rng.random(), seed=1000 + i)
                 * (0.6 + 0.8 * rng.random()) for i in range(n)]
    else:
        clean = [synthetic_speech(1.0 + rng.random())
                 * (0.6 + 0.8 * rng.random()) for _ in range(n)]
    fs = AudioConfig().sample_rate
    if noise_kind == "multi":
        noises = synthetic_noise_bank(fs * 30, seed=7)
    else:
        noises = {"white": synthetic_noise(fs * 30, seed=7)}
    return clean, noises


def demo(args) -> int:
    """The oracle-mask demo on a synthetic 2 s signal at 0, 5 and 10 dB:
    IRM, PCIRM and the fixed-step OPT-PCIRM from the gammatone analysis of
    the clean, noise and noisy signals on the device, each applied as a
    per-frame scalar gain, the five metrics of each against the clean
    signal, and the masks' statistics."""
    import torch

    from sincformer_tpu_torch.config import AudioConfig
    from sincformer_tpu_torch.data.audio import add_noise_at_snr
    from sincformer_tpu_torch.data.synthetic import (synthetic_noise,
                                                     synthetic_speech)
    from sincformer_tpu_torch.dsp.gammatone import GammatoneFilterbank
    from sincformer_tpu_torch.evaluation.csii import compute_csii
    from sincformer_tpu_torch.evaluation.ncm import compute_ncm
    from sincformer_tpu_torch.evaluation.pesq import compute_pesq
    from sincformer_tpu_torch.evaluation.ssnr import compute_ssnr
    from sincformer_tpu_torch.evaluation.stoi import compute_stoi
    from sincformer_tpu_torch.masks.irm import compute_irm
    from sincformer_tpu_torch.masks.opt_pcirm import (compute_snr_boundaries,
                                                      quantize_pcirm,
                                                      reconstruct_scalar_gain)
    from sincformer_tpu_torch.masks.pcirm import (
        compute_correlation_coefficients, compute_pcirm,
        compute_phase_differences)
    from sincformer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print("=" * 70)
    print("  Speech Enhancement Demo — Synthetic Signal (GPU port)")
    print("=" * 70)
    fs = AudioConfig().sample_rate
    clean = synthetic_speech(2.0, fs)
    noise = synthetic_noise(len(clean), seed=None)
    gfb = GammatoneFilterbank(sample_rate=fs)

    def on_device(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    for snr_db in (0, 5, 10):
        print(f"\n{'─' * 60}\n  SNR = {snr_db} dB\n{'─' * 60}")
        noisy = add_noise_at_snr(clean, noise, snr_db)
        with torch.inference_mode():
            clean_m, clean_p = gfb.get_tf_magnitudes(on_device(clean))
            noisy_m, noisy_p = gfb.get_tf_magnitudes(on_device(noisy))
            noise_m, noise_p = gfb.get_tf_magnitudes(
                on_device(noise[:len(clean)]))
            irm = compute_irm(clean_m, noise_m)
            rho_s, rho_n = compute_correlation_coefficients(
                noisy_m, clean_m, noise_m)
            phi1, phi2 = compute_phase_differences(noisy_p, clean_p, noise_p)
            pcirm = compute_pcirm(clean_m, noise_m, rho_s, rho_n, phi1, phi2)
            opt = quantize_pcirm(pcirm, compute_snr_boundaries()[0])
            outs = {"Noisy": noisy}
            for name, mask in (("IRM", irm), ("PCIRM", pcirm),
                               ("OPT-PCIRM", opt)):
                outs[name] = reconstruct_scalar_gain(
                    mask, on_device(noisy)).cpu().numpy()

        cols = list(outs.keys())
        print(f"\n  {'Metric':<12}" + "".join(f"{c:>12}" for c in cols))
        print("  " + "─" * (12 + 12 * len(cols)))
        for mname, fn in (("STOI", compute_stoi), ("PESQ", compute_pesq),
                          ("SSNR (dB)", compute_ssnr), ("CSII", compute_csii),
                          ("NCM", compute_ncm)):
            print(f"  {mname:<12}" + "".join(
                f"{fn(clean, outs[c], device=device):>12.4f}" for c in cols))

        print("\n  Mask stats:")
        for name, mask in (("IRM     ", irm), ("PCIRM   ", pcirm)):
            print(f"    {name} — mean={float(mask.mean()):.3f}, "
                  f"std={float(mask.std(unbiased=False)):.3f}")
        uniq = np.unique(np.round(opt.cpu().numpy(), 4))
        print(f"    OPT-PCIRM— unique values={uniq}, "
              f"mean={float(opt.mean()):.3f}")
    print(f"\n{'=' * 70}\n  Demo complete!\n{'=' * 70}\n")
    return 0


def train(args) -> int:
    """Train the mask DNN (``--pipeline dnn``), DCSE (``conformer`` or
    ``dcse``) or the flagship (``agents``) on TIMIT + NOISEX-92, or on a
    synthetic corpus with ``--synthetic N``, then save the final
    checkpoint."""
    from sincformer_tpu_torch.config import AudioConfig, DataConfig
    from sincformer_tpu_torch.data.audio import load_audio
    from sincformer_tpu_torch.data.loader import (find_speech_files,
                                                  load_noise_signals,
                                                  train_test_split)

    logger = None
    if args.log_jsonl:
        from sincformer_tpu_torch.utils.observability import MetricsLogger
        logger = MetricsLogger(args.log_jsonl)
    synthetic = None
    if args.synthetic:
        synthetic = _synthetic_corpus(args.synthetic, args.synth_noises,
                                      args.synth_speech)
    elif not find_speech_files():
        print(f"  No speech files in {DataConfig().timit_dir}",
              file=sys.stderr)
        return 1

    if args.pipeline in ("conformer", "dcse"):
        from sincformer_tpu_torch.data.loader import (WaveformDataset,
                                                      heldout_noises)
        from sincformer_tpu_torch.train.dcse_trainer import DCSETrainer
        print("=" * 70)
        print("  Speech Enhancement — DCSE Conformer Training (GPU port)")
        print("=" * 70)
        pipe = DCSETrainer(device=args.device, model_dir=_model_dir(),
                           seed=args.seed, logger=logger)
        if synthetic:
            clean, noises = synthetic
            split = max(1, int(0.9 * len(clean)))
            train_ds = WaveformDataset.from_arrays(clean[:split], noises)
            test_ds = WaveformDataset.from_arrays(clean[split:],
                                                  heldout_noises(noises))
        else:
            train_ds, test_ds = pipe.prepare_data(max_train=args.max_train,
                                                  max_test=args.max_test)
        n_params = sum(p.numel() for p in pipe.model.parameters())
        print(f"  {n_params} parameters on {pipe.device}; {len(train_ds)} "
              f"training and {len(test_ds)} validation utterances")
        pipe.train(train_ds, test_ds, epochs=args.epochs, resume=args.resume)
    elif args.pipeline == "agents":
        from sincformer_tpu_torch.train import agent_trainer
        print("=" * 70)
        print("  Speech Enhancement — Sincformer Metacog Training (GPU port)")
        print("=" * 70)
        fs = AudioConfig().sample_rate
        if synthetic:
            clean, noises = synthetic
            split = max(1, int(0.9 * len(clean)))
            clean_tr, clean_te = clean[:split], clean[split:]
        else:
            tr_files, te_files = train_test_split(
                find_speech_files(), max_train=args.max_train,
                max_test=args.max_test)
            clean_tr = [load_audio(f, fs) for f in tr_files]
            clean_te = [load_audio(f, fs) for f in te_files]
            noises = load_noise_signals(fs)
        model = agent_trainer.default_metacog(cpea_impl=args.cpea,
                                              pa_impl=args.pa)
        print(f"  Variant: pa {model.config.pa_impl}, cpea "
              f"{model.config.cpea_impl}, fine stream "
              f"{model.config.pa_fine_act}/{model.config.pa_fine_feats}")
        pipe = agent_trainer.SincformerTrainer(
            model, device=args.device,
            model_dir=_model_dir(), seed=args.seed, logger=logger,
            use_adversarial=args.adversarial)
        n_params = sum(p.numel() for p in pipe.model.parameters())
        print(f"  {n_params} parameters on {pipe.device}; {len(clean_tr)} "
              f"training and {len(clean_te)} validation utterances")
        pipe.train(clean_tr, clean_te, noises, epochs=args.epochs,
                   resume=args.resume)
    else:
        from sincformer_tpu_torch.train.dnn_trainer import DNNTrainer
        print("=" * 70)
        print("  Speech Enhancement — DNN Training (GPU port)")
        print("=" * 70)
        pipe = DNNTrainer(mask_type=args.mask_type, device=args.device,
                          model_dir=_model_dir(), seed=args.seed,
                          logger=logger, use_rbm_pretrain=not args.no_rbm)
        if synthetic:
            train_ds, test_ds = pipe.prepare_arrays(*synthetic)
        else:
            train_ds, test_ds = pipe.prepare_data(max_train=args.max_train,
                                                  max_test=args.max_test)
        print(f"  {len(train_ds)} training and {len(test_ds)} test frames "
              f"on {pipe.device}")
        pipe.train(train_ds, test_ds, epochs=args.epochs, resume=args.resume)
    print(f"  Saved {pipe.save_model()}")
    print("\nTraining complete!")
    return 0


def evaluate(args) -> int:
    """The five-metric grid over every trained model under the model
    directory (``evaluation/grid.py``); ``--ckpt best`` scores the
    best-validation checkpoints instead of the final ones."""
    from sincformer_tpu_torch.evaluation.grid import run_grid_evaluation
    os.environ["SINCFORMER_CKPT_PREF"] = args.ckpt
    summary = run_grid_evaluation(
        max_eval=args.max_eval, model_dir=_model_dir(),
        distributed=args.distributed, use_mesh=args.mesh,
        synth_noises=args.synth_noises, synth_speech=args.synth_speech,
        json_out=args.json_out, device=args.device)
    return 0 if summary is not None else 1


def calibrate(args) -> int:
    """Fit the output gain of a trained checkpoint on held-out mixtures
    and persist it in the checkpoint's sidecar: the TIMIT validation split
    when the dataset is there (and ``--synthetic`` is not given), else
    synthetic utterances of 2 s drawn from ``eval_sample_seed + 1`` (apart
    from the training corpus and from the evaluation draw) with a fresh
    white noise."""
    from sincformer_tpu_torch.config import AudioConfig, DataConfig
    from sincformer_tpu_torch.data.audio import load_audio
    from sincformer_tpu_torch.data.loader import (WaveformDataset,
                                                  find_speech_files,
                                                  heldout_noises,
                                                  load_noise_signals,
                                                  train_test_split)

    fs = AudioConfig().sample_rate
    files = find_speech_files()
    if files and not args.synthetic:
        _, te_files = train_test_split(files, max_test=args.samples)
        clean = [load_audio(f, fs) for f in te_files]
        # the raw bank: calibrate_gain takes the held-out crops itself
        noises = load_noise_signals(fs)
        print(f"  Calibration set: {len(clean)} TIMIT val utterances "
              f"(held-out noise crops)")
    else:
        from sincformer_tpu_torch.data.synthetic import synthetic_speech
        rng = np.random.default_rng(DataConfig().eval_sample_seed + 1)
        clean = [synthetic_speech(2.0) * (0.7 + 0.6 * rng.random())
                 for _ in range(args.samples)]
        noises = {"white": (rng.standard_normal(fs * 30) * 0.3
                            ).astype(np.float32)}
        print(f"  Calibration set: {len(clean)} synthetic utterances "
              f"(fresh noise realization)")
    make, _, _ = _family(args.model)
    pipe = make(device=args.device, model_dir=_model_dir())
    pipe.load_model()
    before = pipe.output_gain
    if args.model == "sincformer":
        after = pipe.calibrate_gain(clean, noises)
    else:
        # DCSE takes an already mixed set: the held-out crops are taken
        # here, once
        after = pipe.calibrate_gain(WaveformDataset.from_arrays(
            clean, heldout_noises(noises)))
    print(f"  Output gain: {before:.4f} → {after:.4f} "
          f"(persisted in the checkpoint sidecar)")
    return 0


def info(args) -> int:
    """Configuration and device."""
    import torch

    from sincformer_tpu_torch.config import (AudioConfig, DCSEConfig,
                                             DNNConfig, GammatoneConfig,
                                             MetacogConfig)
    acfg, dcfg = AudioConfig(), DNNConfig()
    print("=" * 70)
    print("  Speech Enhancement System - Configuration (sincformer_tpu_torch)")
    print("=" * 70)
    print(f"\n  Sample Rate:        {acfg.sample_rate} Hz")
    print(f"  Frame Size:         {acfg.frame_size} samples")
    print(f"  Hop Size:           {acfg.hop_size} samples")
    print(f"  GFTB Channels:      {GammatoneConfig().num_channels}")
    print(f"  DNN Hidden Layers:  {dcfg.hidden_layers}")
    print(f"  DNN Hidden Units:   {dcfg.hidden_units}")
    print(f"  DNN Dropout:        {dcfg.dropout}")
    print(f"  Flagship:           {MetacogConfig()}")
    print(f"  DCSE:               {DCSEConfig()}")
    print(f"\n  PyTorch Version:    {torch.__version__}")
    print(f"  CUDA available:     {torch.cuda.is_available()}")
    if torch.cuda.is_available():
        print(f"  Device:             {torch.cuda.get_device_name(0)} "
              f"(x{torch.cuda.device_count()})")
    print(f"\n  Model Dir:          {_model_dir()}")
    for name, path, variant in flagship_checkpoints(_model_dir()):
        print(f"  {name + ':':<20}{path} ({variant})")
    return 0


def flagship_checkpoints(model_dir: str):
    """(family, newest step, variant) of each flagship checkpoint family
    under ``model_dir``; the variant as ``load_model`` reads it, from the
    weights' names, or what fails to read."""
    from sincformer_tpu_torch.agents.metacog import variant_of
    from sincformer_tpu_torch.pipeline import SincformerPipeline
    from sincformer_tpu_torch.train.state import (latest_step_dir,
                                                  restore_checkpoint)
    found = []
    for name in (SincformerPipeline.FINAL_NAME, SincformerPipeline.BEST_NAME):
        path = latest_step_dir(os.path.join(model_dir, name))
        if path is None:
            continue
        try:
            v = variant_of(restore_checkpoint(path)["params"])
            variant = ", ".join(f"{k} {v[k]}" for k in sorted(v))
        except (OSError, RuntimeError, KeyError) as e:
            variant = f"unreadable: {e}"
        found.append((name, path, variant))
    return found


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sincformer_tpu_torch",
        description="Speech enhancement on the GPU: Sincformer metacog, "
                    "the DCSE Conformer and the original paper's mask DNN "
                    "(PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command")

    enp = sub.add_parser("enhance", help="Enhance WAV file(s)")
    enp.add_argument("input", nargs="+", help="Input WAV path(s)")
    enp.add_argument("output", help="Output WAV path (single input) or "
                                    "output directory (several inputs)")
    enp.add_argument("--pcm16", action="store_true",
                     help="write 16-bit PCM WAV output (default: float32)")
    enp.add_argument("--online", action="store_true",
                     help="causal low-latency mode (50 ms bounded "
                          "algorithmic latency): audio is fed in 20 ms "
                          "chunks through the online enhancer; several "
                          "inputs run as concurrent streams through the "
                          "batched pool")
    enp.add_argument("--model", default=None, choices=list(_MODELS),
                     help="Model to use (default: best available, in this "
                          "order)")

    xp = sub.add_parser("export",
                        help="Export a trained checkpoint as a compact "
                             "int8 serving artifact (drop-in model dir)")
    xp.add_argument("--model", default="sincformer",
                    choices=["sincformer", "conformer", "dnn"])
    xp.add_argument("--mask-type", default="pcirm", choices=list(_MASK_TYPES),
                    help="mask head of the DNN checkpoint (--model dnn)")
    xp.add_argument("--ckpt", default="best", choices=["final", "best"],
                    help="checkpoint family to export (default: the "
                         "best-validation checkpoint)")
    xp.add_argument("--out", default=None, metavar="DIR",
                    help="output model dir (default: "
                         "<SINCFORMER_MODEL_DIR>_serving)")

    sub.add_parser("demo", help="Quick demo on synthetic data (no dataset "
                                "or model needed)")

    tp = sub.add_parser("train", help="Train on TIMIT + NOISEX-92 or a "
                                      "synthetic corpus")
    tp.add_argument("--pipeline", default="dnn",
                    choices=["dnn", "conformer", "dcse", "agents"],
                    help="dnn (the original paper's mask DNN), conformer or "
                         "dcse (DCSE), agents (Sincformer metacog)")
    tp.add_argument("--mask-type", default="pcirm", choices=list(_MASK_TYPES),
                    dest="mask_type", help="the mask DNN's target")
    tp.add_argument("--no-rbm", action="store_true", dest="no_rbm",
                    help="skip the mask DNN's RBM pretraining")
    tp.add_argument("--epochs", type=int, default=None)
    tp.add_argument("--max-train", type=int, default=100)
    tp.add_argument("--max-test", type=int, default=20)
    tp.add_argument("--pa", default="mxu", choices=["mxu", "reference"],
                    help="PerceptionAgent formulation (agents pipeline)")
    tp.add_argument("--cpea", default="lstm", choices=["lstm", "ssm"],
                    help="CPEA sequence mixer: 'lstm' (reference parity) or"
                         " 'ssm' (bidirectional LRU)")
    tp.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint (full training "
                         "state) and continue from the epoch after it")
    tp.add_argument("--adversarial", action="store_true",
                    help="the 3-scale adversarial loss in curriculum stage "
                         "3, with its own discriminator optimizer")
    tp.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on N synthetic utterances (no datasets "
                         "needed)")
    tp.add_argument("--synth-noises", default="white",
                    choices=["white", "multi"], dest="synth_noises",
                    help="--synthetic noise bank: one white noise or the "
                         "4-class synthetic bank")
    tp.add_argument("--synth-speech", default="formant",
                    choices=["formant", "varied"], dest="synth_speech",
                    help="--synthetic utterances: the fixed formant pattern "
                         "or one randomized utterance per index")
    tp.add_argument("--seed", type=int, default=0,
                    help="training seed (weights, dropout, routing, "
                         "minibatch order)")
    tp.add_argument("--log-jsonl", default=None, metavar="PATH",
                    dest="log_jsonl",
                    help="write per-epoch metrics (JSONL) to PATH")

    def eval_args(p):
        p.add_argument("--max-eval", type=int, default=50)
        p.add_argument("--mesh", action="store_true",
                       help="shard the metric sweep over every visible "
                            "device (one card: unsharded)")
        p.add_argument("--distributed", action="store_true",
                       help="deal the (noise x SNR) cells to the processes "
                            "of a group and merge them: start one process "
                            "per card with torchrun, which sets RANK, "
                            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT and "
                            "LOCAL_RANK (the card), e.g. torchrun "
                            "--nproc_per_node=2 -m sincformer_tpu_torch.cli "
                            "evaluate --distributed; the parts meet in "
                            "<SINCFORMER_MODEL_DIR>/_distributed_eval")
        p.add_argument("--synth-noises", default="white",
                       choices=["white", "multi"], dest="synth_noises",
                       help="without NOISEX-92: one white noise or the "
                            "4-class synthetic bank")
        p.add_argument("--synth-speech", default="formant",
                       choices=["formant", "varied"], dest="synth_speech",
                       help="without TIMIT: the fixed formant pattern or "
                            "one randomized utterance per index")
        p.add_argument("--ckpt", default="final", choices=["final", "best"],
                       help="checkpoint family to score")
        p.add_argument("--json-out", default=None, metavar="PATH",
                       dest="json_out",
                       help="write every per-cell value and the summary "
                            "as JSON to PATH")

    ep = sub.add_parser("evaluate", help="Full 5-metric grid evaluation")
    eval_args(ep)
    tstp = sub.add_parser("test", help="Alias for evaluate")
    eval_args(tstp)

    cp = sub.add_parser("calibrate",
                        help="Fit and persist the output-gain calibration "
                             "of a trained checkpoint")
    cp.add_argument("--model", default="sincformer",
                    choices=["sincformer", "conformer"])
    cp.add_argument("--samples", type=int, default=8,
                    help="held-out utterances to fit the gain on")
    cp.add_argument("--synthetic", action="store_true",
                    help="the synthetic corpus even if TIMIT exists")

    ip = sub.add_parser("info", help="Print configuration and device")
    for p in (sub.choices["demo"], enp, xp, tp, ep, tstp, cp, ip):
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu on request)")
    return parser


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "demo":
        return demo(args)
    if args.command == "enhance":
        return enhance(args)
    if args.command == "export":
        return export(args)
    if args.command == "train":
        return train(args)
    if args.command in ("evaluate", "test"):
        return evaluate(args)
    if args.command == "calibrate":
        return calibrate(args)
    if args.command == "info":
        return info(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
