"""WavTokenizer codec GAN training, on one device or data-parallel.

Counterpart of ``llmvox_tpu/train/codec_trainer.py``:

- the **generator** is the SEANet encoder (weight norm) -> the EMA VQ
  (straight-through, commitment) -> the ConvNeXt backbone -> the ISTFT
  head; under ``step_impl="micro"`` the encoder and the backbone with the
  head are recomputed in the backward pass (``torch.utils.checkpoint``),
  as JAX's micro step runs them under ``jax.checkpoint``;
- one step is the alternating pair as one eager step: the **disc half**
  runs the generator without the VQ update (``train=False``, no
  gradient) and updates the MPD, MRD and DAC discriminators on the hinge
  and least-squares losses; the **gen half** runs it with the VQ update
  and updates it on the adversarial, feature-matching, mel (x 45) and
  commitment (x 1000) losses against the *updated* discriminators;
- both AdamW optimizers follow ``warmup_cosine_lr`` over max_steps // 2
  (``train/optim.py``); under ``pretrain_mel_steps`` the disc gradients
  are zeroed but the update (weight decay, the moments) still runs, and
  the adversarial terms are off.

JAX's ``step_impl`` values ("fused", "split", "micro") size its compiled
programs; the port runs this one step for each, with the recompute
under "micro" as JAX's.  The bandwidth id and the
VQ's row draws of a step come from the trainer's CPU ``torch.Generator``
(the same draws on every device) or are passed in (``StepDraws``), so a
test can feed JAX's.

Data parallelism runs one process a card under ``torchrun``, where JAX's
trainer runs one GSPMD program over a dp mesh (``dp_size`` -1 is the
launch's world size).  ``step`` takes the global batch and each rank keeps
its block of rows; the draws come from generators seeded alike on every
rank and index the global rows; the VQ gathers its k-means input and sums
its EMA statistics over the ranks (``vq_train.py``); the discriminator
and generator gradients and the logs are averaged over the ranks (every
loss is a mean over equal blocks, so the mean of the ranks' is the
batch's); rank 0 writes checkpoints.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from llmvox_tpu_torch.codec import backbone as bb
from llmvox_tpu_torch.codec import discriminators as disc
from llmvox_tpu_torch.codec import heads, losses, seanet
from llmvox_tpu_torch.ops.istft import np_dtype
from llmvox_tpu_torch.ops.nn import effective_weight
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel.sharding import dp_rows
from llmvox_tpu_torch.train import checkpoint as ckpt
from llmvox_tpu_torch.train.optim import AdamW
from llmvox_tpu_torch.train.vq_train import (VQState, draw_indices,
                                             init_vq_state, vq_infer,
                                             vq_train_step)
from llmvox_tpu_torch.utils.config import CodecConfig, CodecTrainConfig
from llmvox_tpu_torch.utils.device import resolve_device
from llmvox_tpu_torch.utils.params import (init_codec_params, vq_from_numpy,
                                           vq_to_numpy)

LOG_KEYS = ("disc_mp", "disc_mrd", "disc_dac", "disc_total", "grad_norm_gen",
            "gen_total", "mel", "commit", "gen_mp", "gen_mrd", "fm_mp",
            "fm_mrd", "dac_g", "dac_feat")


class StepDraws(NamedTuple):
    """What a step draws: the backbone's bandwidth id, k-means' initial
    rows (read only while the codebook is uninitialised) and the dead
    codes' replacement rows."""
    bandwidth_id: int
    init_idx: torch.Tensor
    dead_idx: torch.Tensor


class CodecTrainState(NamedTuple):
    gen_params: Dict
    disc_params: Dict
    vq_state: VQState
    opt_g: AdamW
    opt_d: AdamW
    step: int


def init_generator_params(seed: int, cfg: CodecConfig) -> Dict:
    """Encoder (weight norm), backbone and head, drawn by numpy."""
    codec = init_codec_params(seed, cfg)
    return {"encoder": seanet.init_seanet_encoder(seed + 1, cfg,
                                                  weight_norm=True),
            "backbone": codec["backbone"], "head": codec["head"]}


def init_discriminator_params(seed: int, tcfg: CodecTrainConfig) -> Dict:
    return {"mpd": disc.init_mpd(seed, tcfg.mpd_periods),
            "mrd": disc.init_mrd(seed + 1, tcfg.mrd_resolutions),
            "dac": disc.init_dac(seed + 2, tcfg.dac_periods,
                                 tcfg.dac_fft_sizes)}


def encoded_length(num_samples: int, cfg: CodecConfig) -> int:
    """Frames the SEANet encoder makes of ``num_samples``: each strided
    conv's "same-style" padding rounds up."""
    n = num_samples
    for ratio in cfg.downsamples:
        n = -(-n // ratio)
    return n


# ---------------------------------------------------------------------------
# params as modules
# ---------------------------------------------------------------------------

def _refill(tree, leaves):
    """``tree`` with its leaves, in JAX's leaf order (dict keys sorted),
    taken from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _refill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_refill(v, leaves) for v in tree]
    return next(leaves)


class TreeModule(torch.nn.Module):
    """A params tree's leaves (f32, or ``dtype``) as this module's
    parameters, in JAX's leaf order (``names`` their checkpoint paths);
    ``tree()`` rebuilds the tree of parameters, which the functions of
    ``codec/`` take as they take any params tree."""

    def __init__(self, tree: Dict, device, dtype=torch.float32):
        super().__init__()
        flat = ckpt.flatten_pytree(tree)
        self.names = list(flat)
        # copies: the caller's arrays stay as they were
        self.params = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.tensor(a).to(device, dtype))
             for a in flat.values()])
        self._skeleton = tree

    def tree(self) -> Dict:
        return _refill(self._skeleton, iter(self.params))


# ---------------------------------------------------------------------------
# the generator and the losses
# ---------------------------------------------------------------------------

def generator_forward(gen: Dict, vq_state: VQState, audio: torch.Tensor,
                      bandwidth_id: int, cfg: CodecConfig,
                      tcfg: CodecTrainConfig, *, train: bool = True,
                      draws: Optional[StepDraws] = None,
                      remat: bool = False, sync: bool = False):
    """audio (B, T) -> (audio_hat (B, T'), commit loss, new VQ state, the
    (B * L,) codes).  ``train`` runs the VQ's training pass (``draws``
    gives its rows; ``sync`` over the data-parallel ranks); otherwise the
    inference assignment, commit 0 and the state as it was."""
    if remat:
        emb = checkpoint(seanet.apply_seanet_encoder, gen["encoder"], audio,
                         cfg, use_reentrant=False)
    else:
        emb = seanet.apply_seanet_encoder(gen["encoder"], audio, cfg)
    b, l, d = emb.shape
    flat = emb.reshape(b * l, d)
    if train:
        quant, codes, commit, vq_state = vq_train_step(
            vq_state, flat, draws.init_idx, draws.dead_idx,
            decay=tcfg.vq_decay, threshold_dead=tcfg.vq_threshold_dead,
            kmeans_iters=tcfg.vq_kmeans_iters, sync=sync)
    else:
        quant, codes = vq_infer(vq_state, flat)
        commit = audio.new_zeros(())

    def synth(backbone, head, feats):
        h = bb.apply_backbone(backbone, feats, bandwidth_id, cfg)
        return heads.apply_istft_head(head, h, cfg)

    feats = quant.reshape(b, l, d)
    if remat:
        audio_hat = checkpoint(synth, gen["backbone"], gen["head"], feats,
                               use_reentrant=False)
    else:
        audio_hat = synth(gen["backbone"], gen["head"], feats)
    return audio_hat, commit, vq_state, codes


def _vocos_scores(dp: Dict, y, y_hat, tcfg: CodecTrainConfig):
    mp = [(disc.apply_discriminator_p(p, y, per),
           disc.apply_discriminator_p(p, y_hat, per))
          for p, per in zip(dp["mpd"], tcfg.mpd_periods)]
    mrd = [(disc.apply_discriminator_r(p, y, res),
            disc.apply_discriminator_r(p, y_hat, res))
           for p, res in zip(dp["mrd"], tcfg.mrd_resolutions)]
    return mp, mrd


def disc_loss(dp: Dict, y: torch.Tensor, y_hat: torch.Tensor,
              tcfg: CodecTrainConfig) -> Tuple[torch.Tensor, Dict]:
    """The discriminators' loss on real ``y`` and generated ``y_hat``
    (its total and the log terms)."""
    mp, mrd = _vocos_scores(dp, y, y_hat, tcfg)
    loss_mp = losses.discriminator_loss(
        [r[0] for r, _ in mp], [g[0] for _, g in mp]) / len(mp)
    loss_mrd = losses.discriminator_loss(
        [r[0] for r, _ in mrd], [g[0] for _, g in mrd]) / len(mrd)
    d_fake = disc.apply_dac(dp["dac"], y_hat, tcfg.dac_periods,
                            tcfg.dac_fft_sizes)
    d_real = disc.apply_dac(dp["dac"], y, tcfg.dac_periods,
                            tcfg.dac_fft_sizes)
    loss_dac = losses.dac_discriminator_loss(d_fake, d_real)
    total = loss_mp + tcfg.mrd_loss_coeff * loss_mrd + loss_dac
    return total, {"disc_mp": loss_mp, "disc_mrd": loss_mrd,
                   "disc_dac": loss_dac, "disc_total": total}


def gen_loss(dp: Dict, y: torch.Tensor, y_hat: torch.Tensor,
             commit: torch.Tensor, train_disc: float,
             tcfg: CodecTrainConfig) -> Tuple[torch.Tensor, Dict]:
    """The generator's loss on (B, T) ``y`` and ``y_hat`` of one length."""
    mel = losses.mel_loss(y_hat, y, sample_rate=tcfg.sample_rate)
    mp, mrd = _vocos_scores(dp, y, y_hat, tcfg)
    gen_mp = losses.generator_loss([g[0] for _, g in mp]) / len(mp)
    gen_mrd = losses.generator_loss([g[0] for _, g in mrd]) / len(mrd)
    fm_mp = losses.feature_matching_loss(
        [r[1] for r, _ in mp], [g[1] for _, g in mp]) / len(mp)
    fm_mrd = losses.feature_matching_loss(
        [r[1] for r, _ in mrd], [g[1] for _, g in mrd]) / len(mrd)
    d_fake = disc.apply_dac(dp["dac"], y_hat, tcfg.dac_periods,
                            tcfg.dac_fft_sizes)
    d_real = disc.apply_dac(dp["dac"], y, tcfg.dac_periods,
                            tcfg.dac_fft_sizes)
    dac_g, dac_feat = losses.dac_generator_loss(d_fake, d_real)
    adv = (gen_mp + tcfg.mrd_loss_coeff * gen_mrd + fm_mp +
           tcfg.mrd_loss_coeff * fm_mrd + dac_g + dac_feat)
    total = (train_disc * adv + tcfg.mel_loss_coeff * mel +
             tcfg.commit_loss_coeff * commit)
    return total, {"gen_total": total, "mel": mel, "commit": commit,
                   "gen_mp": gen_mp, "gen_mrd": gen_mrd, "fm_mp": fm_mp,
                   "fm_mrd": fm_mrd, "dac_g": dac_g, "dac_feat": dac_feat}


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class CodecTrainer:
    """End-to-end codec GAN training.  ``gen_params``, ``disc_params`` and
    ``vq_state`` (trees in the JAX layout, numpy or tensors) replace the
    seeded initialisation, as assigning ``trainer.state`` does in JAX;
    ``keep_grads`` keeps each step's gradients in ``grads`` and the VQ's
    codes in ``codes``; ``dtype`` float64 runs every tensor in f64, a
    reference for the f32 run's rounding.  Under a process group of N
    ranks it trains data-parallel (the module's docstring)."""

    def __init__(self, cfg: CodecConfig, tcfg: CodecTrainConfig, *,
                 device="cuda", gen_params: Optional[Dict] = None,
                 disc_params: Optional[Dict] = None, vq_state=None,
                 keep_grads: bool = False,
                 dtype=torch.float32):
        self.dp = pmesh.data_parallel_size(tcfg.dp_size)
        if tcfg.batch_size % self.dp:
            raise ValueError(f"batch_size {tcfg.batch_size} must divide "
                             f"over dp={self.dp}")
        self.rank = pmesh.rank()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cfg, self.tcfg = cfg, tcfg
        self.keep_grads = keep_grads
        self.generator = torch.Generator()
        self.generator.manual_seed(tcfg.seed)
        self.gen = TreeModule(gen_params if gen_params is not None else
                              init_generator_params(tcfg.seed, cfg),
                              self.device, dtype)
        self.disc = TreeModule(disc_params if disc_params is not None else
                               init_discriminator_params(tcfg.seed + 10,
                                                         tcfg),
                               self.device, dtype)
        vq = (vq_from_numpy(vq_state, self.device) if vq_state is not None
              else init_vq_state(tcfg.seed + 20, cfg.vq_bins, cfg.vq_dim,
                                 self.device))
        self.vq = VQState(*(t.to(dtype) if t.is_floating_point() else t
                            for t in vq))
        self.opt_g = AdamW(tcfg, list(self.gen.params),
                           [True] * len(self.gen.params))
        self.opt_d = AdamW(tcfg, list(self.disc.params),
                           [True] * len(self.disc.params))
        if self.dp > 1:
            with torch.no_grad():
                pmesh.broadcast_from_master(list(self.gen.params)
                                            + list(self.disc.params))
                pmesh.broadcast_from_master(list(self.vq)[:3])
        self.grads: Dict[str, List[torch.Tensor]] = {}
        self.codes: Optional[torch.Tensor] = None
        self.iter_num = 0

    @property
    def state(self) -> CodecTrainState:
        return CodecTrainState(self.gen.tree(), self.disc.tree(), self.vq,
                               self.opt_g, self.opt_d, self.iter_num)

    def draw(self, batch: int, samples: Optional[int] = None) -> StepDraws:
        """A step's draws from the trainer's generator, for a (global)
        batch of ``batch`` crops of ``samples`` (``num_samples`` by
        default)."""
        bw = int(torch.randint(0, self.cfg.adanorm_num_embeddings, (),
                               generator=self.generator))
        n = batch * encoded_length(samples or self.tcfg.num_samples,
                                   self.cfg)
        return StepDraws(bw, *draw_indices(self.generator, n,
                                           self.cfg.vq_bins))

    def _audio(self, audio) -> torch.Tensor:
        return torch.from_numpy(np.asarray(audio, np_dtype(
            self.dtype))).to(self.device)

    def _train_disc(self) -> float:
        return 1.0 if self.iter_num >= self.tcfg.pretrain_mel_steps else 0.0

    def disc_half(self, y: torch.Tensor, draws: StepDraws) -> Dict:
        """The discriminators' update (optimizer 0) on a device batch: the
        generator frozen, no VQ update; the logs as 0-d tensors."""
        with torch.no_grad():
            y_hat, _, _, _ = generator_forward(
                self.gen.tree(), self.vq, y, draws.bandwidth_id, self.cfg,
                self.tcfg, train=False)
        tlen = min(y.shape[-1], y_hat.shape[-1])
        d_total, logs = disc_loss(self.disc.tree(), y[:, :tlen],
                                  y_hat[:, :tlen], self.tcfg)
        d_grads = [g * self._train_disc() for g in torch.autograd.grad(
            d_total, list(self.disc.params))]
        pmesh.all_reduce_(d_grads, "mean")
        self.opt_d.step(d_grads)
        if self.keep_grads:
            self.grads["disc"] = d_grads
        return logs

    def gen_half(self, y: torch.Tensor, draws: StepDraws) -> Dict:
        """The generator's update (optimizer 1) against the current
        discriminators, with the VQ's training pass; it advances
        ``iter_num``.  The logs as 0-d tensors."""
        disc_p = list(self.disc.params)
        for p in disc_p:
            p.requires_grad_(False)
        try:
            y_hat, commit, new_vq, codes = generator_forward(
                self.gen.tree(), self.vq, y, draws.bandwidth_id, self.cfg,
                self.tcfg, train=True, draws=draws,
                remat=self.tcfg.step_impl == "micro", sync=self.dp > 1)
            tlen = min(y.shape[-1], y_hat.shape[-1])
            g_total, logs = gen_loss(self.disc.tree(), y[:, :tlen],
                                     y_hat[:, :tlen], commit,
                                     self._train_disc(), self.tcfg)
            g_grads = torch.autograd.grad(g_total, list(self.gen.params))
        finally:
            for p in disc_p:
                p.requires_grad_(True)
        pmesh.all_reduce_(g_grads, "mean")
        logs["grad_norm_gen"] = torch.sqrt(sum(g.square().sum()
                                               for g in g_grads))
        self.opt_g.step(g_grads)
        self.vq = new_vq
        self.iter_num += 1
        if self.keep_grads:
            self.grads["gen"] = list(g_grads)
            self.codes = codes
        return logs

    def step(self, audio, draws: Optional[StepDraws] = None
             ) -> Dict[str, float]:
        """One alternating step on a global (B, num_samples) batch (each
        rank keeps its rows): the disc half, then the gen half; the logs
        of both as floats, averaged over the ranks."""
        audio = np.asarray(audio)
        if draws is None:
            draws = self.draw(*audio.shape)
        if self.dp > 1:
            audio = audio[dp_rows(audio.shape[0], self.rank, self.dp)]
        y = self._audio(audio)
        logs = self.disc_half(y, draws)
        logs.update(self.gen_half(y, draws))
        values = torch.stack([torch.as_tensor(logs[k]).detach().double()
                              for k in LOG_KEYS])
        pmesh.all_reduce_([values], "mean")
        return dict(zip(LOG_KEYS, values.tolist()))

    @torch.no_grad()
    def reconstruct(self, audio) -> np.ndarray:
        """Copy-synthesize a batch with the current generator (bandwidth
        0, the VQ's inference assignment)."""
        y_hat = generator_forward(self.gen.tree(), self.vq,
                                  self._audio(audio), 0, self.cfg, self.tcfg,
                                  train=False)[0]
        return y_hat.cpu().numpy()

    @torch.no_grad()
    def validation_metrics(self, audio, full: bool = False
                           ) -> Dict[str, float]:
        """The mel loss on held-out audio (experiment.py:227-258).
        ``full`` adds the reference's validation metric set
        (experiment.py:227-309, metrics/periodicity.py) through
        ``codec/metrics.py::evaluate_pair``, row by row: the mel distance
        on the trainer's device, SI-SNR, periodicity, pitch, voicing F1,
        PESQ and STOI on the host, UTMOS where a scorer is registered;
        each key's mean over the rows (None scores dropped), ``val_``
        prefixed."""
        y = self._audio(audio)
        y_hat = generator_forward(self.gen.tree(), self.vq, y, 0, self.cfg,
                                  self.tcfg, train=False)[0]
        tlen = min(y.shape[-1], y_hat.shape[-1])
        mel = losses.mel_loss(y_hat[:, :tlen], y[:, :tlen],
                              sample_rate=self.tcfg.sample_rate)
        out = {"val_mel_loss": float(mel)}
        if full:
            from llmvox_tpu_torch.codec import metrics as cm
            agg: Dict[str, list] = {}
            for i in range(y.shape[0]):
                for k, v in cm.evaluate_pair(
                        y_hat[i, :tlen], y[i, :tlen],
                        sample_rate=self.tcfg.sample_rate,
                        device=self.device).items():
                    if v is not None:
                        agg.setdefault(k, []).append(float(v))
            out.update({f"val_{k}": float(np.mean(v))
                        for k, v in agg.items()})
        return out

    def save_checkpoint(self, tag: str = "codec_ckpt") -> str:
        """The files JAX's trainer writes: ``<tag>.npz`` (the generator and
        the VQ state, JAX's keys), ``<tag>.disc.npz`` (the discriminators'
        leaves by position); the optimizers' states go to
        ``<tag>.{gen,disc}.adamw.npz`` in the port's layout.  Rank 0
        writes; every rank returns once the files are there."""
        out = self.tcfg.out_dir
        path = os.path.join(out, f"{tag}.npz")
        if not pmesh.is_master():
            pmesh.barrier()
            return path
        ckpt.save_params_npz(path, {"gen": self.gen.tree(),
                                    "vq": vq_to_numpy(self.vq)},
                             meta={"iter_num": self.iter_num})
        ckpt.save_opaque(os.path.join(out, f"{tag}.disc.npz"),
                         self.disc.tree())
        for name, mod, opt in (("gen", self.gen, self.opt_g),
                               ("disc", self.disc, self.opt_d)):
            ckpt.save_opt_state(os.path.join(out, f"{tag}.{name}.adamw.npz"),
                                mod.names, opt.state_dict())
        pmesh.barrier()
        return path

    @torch.no_grad()
    def export_inference_params(self) -> Dict:
        """``WavCodec``'s params: the codebook, the backbone and head, the
        encoder with its weight norms folded (numpy)."""
        def fold(p):
            if isinstance(p, dict) and "v" in p:
                return {"w": effective_weight(p).cpu().numpy(),
                        "b": p["b"].cpu().numpy()}
            if isinstance(p, dict):
                return {k: fold(v) for k, v in p.items()}
            if isinstance(p, list):
                return [fold(v) for v in p]
            return p.cpu().numpy()

        gen = self.gen.tree()
        return {"codebooks": self.vq.embed[None].cpu().numpy(),
                "backbone": fold(gen["backbone"]), "head": fold(gen["head"]),
                "encoder": fold(gen["encoder"])}

