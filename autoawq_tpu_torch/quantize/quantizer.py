"""The AWQ calibration engine: activation-aware scale search, clip search,
and int4 packing, in plain torch ops on the card.

The port's copy of ``autoawq_tpu/quantize/quantizer.py``
(``quantize_linear_params`` :59, ``AwqQuantizer`` :94). The decoder
records every linear's input through ``taps`` (``nn/modules.py``) and
block-to-block activations propagate by calling ``modules.block`` with
``method="plain"``. JAX's jitted ``lax.map`` grids become plain loops under
``torch.inference_mode()``. Kept as in JAX: the duo-scaling formula, the
``s / sqrt(max(s) * min(s))`` normalisation and its ``isfinite`` guard, the
per-group normalised weight mean, the mean squared error against the float
output, q/k out of the clip search, the ``[::step]`` clip token sample and
its 256 / 64 / N column chunks, the order in which scales and clips are
applied, and the propagation of the *unscaled* block output to the next
layer. Statistics run in float32. The search matmuls are float32
``torch.matmul``; this module sets no global switch, so TF32 stays off
unless the caller turned it on (``torch.backends.cuda.matmul.allow_tf32``).

Data-parallel calibration (``mesh=`` with a ``data`` axis; JAX's
``mesh=``, :116, :187-201, ``_shard_batch`` :346): each data rank takes
its contiguous slice of the calibration samples and runs the layer
forwards on it, and every reduction over the batch is summed over the data
group before anything is chosen: the activation means, the scale grid's
losses (one all-reduce of the grid's sums a group) and the clip grid's
errors (one of a column chunk's, over the rows of JAX's global ``[::step]``
token sample that fall in the rank's slice). So each rank makes the
choices one process would, up to the order of the sums; JAX's GSPMD
psums do the same inside its jitted searches. A sample count the axis does
not divide runs unsharded on every rank, with a warning, as JAX's does.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.core.packing import pack_port, pad_cols
from autoawq_tpu_torch.core.quant import (pseudo_quantize_weight,
                                          quantize_weight)
from autoawq_tpu_torch.io.hf import role_out_features
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.models.plugins import (CLIP_AVOID, ScaleGroup,
                                              get_plugin, make_inspect_fn)
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.parallel import distributed as pd
from autoawq_tpu_torch.quantize import scale as scale_mod
from autoawq_tpu_torch.utils.device import resolve_device
from autoawq_tpu_torch.utils.tree import (get_by_path, set_by_path,
                                          to_device)


def _clone(tree):
    """Clone dict / list structure, sharing tensor leaves."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def quantize_linear_params(p: Dict[str, Any], qcfg: AwqConfig
                           ) -> Dict[str, Any]:
    """A float LIN (``kernel [K, N]``) -> a packed port LIN on the kernel's
    device: ``core/packing.pack_port`` of the nibbles and zeros, then
    ``pad_cols`` once. A symmetric weight has no ``qzeros`` (the kernels
    take the constant zero point 8). K is not padded (a deliberate
    difference, ROADMAP §3)."""
    if qcfg.w_bit != 4:
        raise ValueError(
            f"packed kernels are 4-bit only (got w_bit={qcfg.w_bit}); run "
            "quantize(export_compatible=True) and pack externally")
    q, s, z = quantize_weight(p["kernel"], bits=qcfg.w_bit,
                              group_size=qcfg.q_group_size,
                              zero_point=qcfg.zero_point)
    qw, sc, qz = pad_cols(pack_port(q), s,
                          None if z is None else pack_port(z))
    out = {"qweight": qw, "scales": sc}
    if qz is not None:
        out["qzeros"] = qz
    if p.get("bias") is not None:
        out["bias"] = p["bias"]
    return out


def _rows(table: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """A sample chunk's rope rows: a per-sample table [B, S, rot/2] (M-RoPE
    calibration) is sliced with the chunk, a shared [1, S, rot/2] one is
    not."""
    return table if table.shape[0] == 1 else table[lo:lo + n]


class AwqQuantizer:
    """AWQ over every layer of ``params`` (a float tree, tensors or numpy
    arrays, on any device), calibrated on ``calib_tokens`` [n, seq_len], or
    on precomputed input embeds ``calib_inputs`` [n, s, h] (a multimodal
    prompt's: vision features spliced at the image tokens) with their rope
    tables ``calib_rope`` = (cos, sin), [1 | n, s, rot/2] (Qwen2-VL's
    M-RoPE), which replace the embedding lookup and the 1-D rope.
    Runs on the card unless ``device`` names another (RuntimeError with no
    card and no device). Each layer is moved to the device in turn. The
    result is on the CPU, or on the device with ``keep_on_device``. With
    ``mesh`` (``parallel/mesh.build_mesh``) whose ``data`` axis is above
    1, every rank passes the same ``calib_tokens`` and calibrates its
    slice of them (see the module docstring); every rank returns the same
    tree, and only data rank 0 writes ``resume_dir``'s files."""

    def __init__(
        self,
        cfg: ModelConfig,
        qcfg: AwqConfig,
        params: Dict[str, Any],
        calib_tokens,
        *,
        calib_inputs=None,
        calib_rope: Optional[Tuple] = None,
        duo_scaling: bool = True,
        apply_clip: bool = True,
        n_grid: int = 20,
        max_clip_shrink: float = 0.5,
        n_clip_sample_tokens: int = 512,
        compute_dtype: torch.dtype = torch.float32,
        weight_dtype: Optional[torch.dtype] = None,
        progress: bool = True,
        resume_dir: Optional[str] = None,
        n_parallel_calib_samples: Optional[int] = None,
        offload_taps: bool = False,
        max_chunk_memory: Optional[int] = None,
        mesh=None,
        quantize_lm_head: bool = False,
        keep_on_device: bool = False,
        device=None,
    ):
        if calib_tokens is None and calib_inputs is None:
            raise ValueError("need calib_tokens or calib_inputs")
        modules.check_supported(cfg)
        self.cfg = cfg
        self.qcfg = qcfg
        self.params = params
        self.calib_tokens = (None if calib_tokens is None
                             else np.asarray(calib_tokens))
        self.calib_inputs = (None if calib_inputs is None
                             else torch.as_tensor(calib_inputs))
        self.calib_rope = calib_rope
        self.mesh = mesh
        self._ddp = mesh.size("data") if mesh is not None else 1
        n_calib = len(self.calib_tokens if self.calib_tokens is not None
                      else self.calib_inputs)
        if self._ddp > 1 and n_calib % self._ddp:
            logging.getLogger(__name__).warning(
                "calib sample count %d not divisible by data axis %d; "
                "calibration runs replicated", n_calib, self._ddp)
            self.mesh, self._ddp = None, 1
        self._data = self.mesh.axis("data") if self._ddp > 1 else None
        self.device = resolve_device(device)
        self.duo_scaling = duo_scaling
        self.do_clip = apply_clip
        self.n_grid = n_grid
        self.max_clip_shrink = max_clip_shrink
        self.n_clip_sample_tokens = n_clip_sample_tokens
        self.compute_dtype = compute_dtype
        # weight_dtype=bf16 halves each layer's upload; the statistics and
        # the quantize math stay f32 either way. None keeps the dtype given
        self.weight_dtype = weight_dtype
        # keep_on_device with resume_dir: each finished layer stays on the
        # device and its file gets a host copy (JAX refuses the pair,
        # ROADMAP §3)
        self.keep_on_device = keep_on_device
        self.resume_dir = resume_dir
        self.quantize_lm_head = quantize_lm_head
        self.progress = progress
        # memory choreography for a large model on one card: calibration
        # forwards in sample chunks (n_parallel_calib_samples), recorded
        # inputs in host memory between searches (offload_taps), a byte
        # budget for the f32 statistics (max_chunk_memory: the token chunk
        # of the |x| mean and the clip search's column chunk); the weights
        # already move to the device one layer at a time
        self.n_parallel = n_parallel_calib_samples
        self.offload_taps = offload_taps
        self.max_chunk_memory = max_chunk_memory
        self.plugin = get_plugin(cfg.model_type)
        self._skip = tuple(qcfg.modules_to_not_convert or ())
        self.out_features_map = role_out_features(cfg)
        # recorded per layer: (group, scales) and (path, clip max-vals) on
        # the CPU, and each scale group's grid losses and chosen index
        self.all_scales: List[List[Tuple[ScaleGroup, torch.Tensor]]] = []
        self.all_clips: List[List[Tuple[str, torch.Tensor]]] = []
        self.scale_choices: List[List[Dict[str, Any]]] = []
        # wall seconds by part (the device drained at each boundary)
        self.timings = dict.fromkeys(
            ("tapped_forward", "scale_search", "clip_search", "pack"), 0.0)

    # ------------------------------------------------------------------ #

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _clock(self, part: str, t0: float) -> float:
        """Add the seconds since ``t0`` (after the device drains) to
        ``part``; returns the new start."""
        self._sync()
        t = time.perf_counter()
        self.timings[part] += t - t0
        return t

    @torch.inference_mode()
    def quantize(self, export_compatible: bool = False) -> Dict[str, Any]:
        """Run AWQ over all layers; returns the new parameter tree.
        ``export_compatible=True`` leaves the scaled and clipped float
        weights in place; call :meth:`pack` after."""
        if not export_compatible and self.qcfg.w_bit != 4:
            # fail before layer 0's calibration, not after it
            raise ValueError(
                f"packed kernels are 4-bit only (w_bit={self.qcfg.w_bit}); "
                "use quantize(export_compatible=True) and pack externally")
        cfg, dev = self.cfg, self.device
        if self.calib_inputs is not None:  # precomputed input embeds
            x = self._local(self.calib_inputs).to(dev, self.compute_dtype)
            s = x.shape[1]
            ar = torch.arange(s, device=dev)
        else:
            # the calibration inputs of JAX's quantize(): learned positions
            # and bloom's embedding LayerNorm, rope tables keyed on the
            # length, and the ALiBi bias in the mask
            tokens = torch.from_numpy(self._local(self.calib_tokens)).to(dev)
            emb = {k: to_device(self.params[k], dev)
                   for k in ("embed_tokens", "embed_positions", "embed_ln")
                   if k in self.params}
            s = tokens.shape[1]
            ar = torch.arange(s, device=dev)
            x = modules.embed(cfg, emb, tokens, dtype=self.compute_dtype,
                              positions=ar[None, :])
        if self.calib_rope is not None:
            cos, sin = (torch.as_tensor(t).float().to(dev)
                        for t in self.calib_rope)
            if cos.shape[0] > 1:  # a table a sample: this rank's samples'
                cos, sin = self._local(cos), self._local(sin)
        else:
            cos, sin = modules.rope_tables(cfg, ar[None, :], seq_len=s)
        mask = modules.causal_mask(s, device=dev,
                                   sliding_window=cfg.sliding_window)
        if cfg.pos_embed == "alibi":
            mask = mask + modules.alibi_bias(cfg, ar, ar)

        new_layers = []
        iterator = range(cfg.num_hidden_layers)
        if self.progress:
            try:
                from tqdm import tqdm

                iterator = tqdm(iterator, desc="AWQ", unit="layer")
            except ImportError:
                pass
        for i in iterator:
            # per-layer resume: a finished layer's file holds its packed
            # tree and the activation stream after it
            ck = self._resume_path(i)
            if ck is not None and os.path.exists(ck):
                lp, x = load_layer_ckpt(ck)
                new_layers.append(to_device(lp, dev) if self.keep_on_device
                                  else lp)
                x = self._local(x).to(dev)
                continue
            lp = to_device(self.params["layers"][i], dev, self.weight_dtype)
            # [1] record each linear's input; propagate the float output
            t0 = time.perf_counter()
            taps: Dict[str, torch.Tensor] = {}
            next_x = self._block_tapped(lp, x, cos, sin, mask, taps)
            t0 = self._clock("tapped_forward", t0)
            # [2] scale search and fold
            layer_scales, choices = [], []
            for group in self.plugin.scale_groups(cfg, lp):
                scales, best, losses = self._search_best_scale(
                    lp, group, taps, cos, sin, mask)
                scale_mod.apply_scale(lp, group, scales, taps,
                                      norm_offset=cfg.norm_offset)
                layer_scales.append((group, scales.cpu()))
                choices.append({"group": group, "best": best,
                                "losses": losses})
            self.all_scales.append(layer_scales)
            self.scale_choices.append(choices)
            t0 = self._clock("scale_search", t0)
            # [3] clip search and clamp
            layer_clips = []
            if self.do_clip:
                avoid = CLIP_AVOID + getattr(self.plugin, "extra_clip_avoid",
                                             ())
                for path in self._quantizable(lp):
                    if any(a in path for a in avoid) or path not in taps:
                        continue
                    w = get_by_path(lp, path)["kernel"]
                    max_val = self._search_best_clip(w, taps[path])
                    scale_mod.apply_clip(lp, path, max_val)
                    layer_clips.append((path, max_val.cpu()))
            self.all_clips.append(layer_clips)
            taps.clear()  # release the recorded inputs before packing
            t0 = self._clock("clip_search", t0)
            # [4] quantize and pack
            if not export_compatible:
                for path in self._quantizable(lp):
                    set_by_path(lp, path, quantize_linear_params(
                        get_by_path(lp, path), self.qcfg))
            new_layers.append(lp if self.keep_on_device
                              else to_device(lp, "cpu"))
            self._clock("pack", t0)
            x = next_x
            if ck is not None:
                # the whole batch's stream, so any rank count resumes
                xs = x if self._data is None else pd.all_gather(
                    x, self._data, dim=0)
                if self._data is None or self._data.index == 0:
                    save_layer_ckpt(ck, new_layers[-1], xs)

        home = dev if self.keep_on_device else "cpu"
        out = to_device({k: v for k, v in self.params.items()
                         if k not in ("layers", "_extra")}, home)
        if "_extra" in self.params:  # unmodeled tensors stay on the CPU
            out["_extra"] = self.params["_extra"]
        out["layers"] = new_layers
        if (self.quantize_lm_head and not export_compatible
                and self.params.get("lm_head") is not None):
            out["lm_head"] = to_device(self._quantize_head(x), home)
        return out

    def _quantize_head(self, x: torch.Tensor) -> Dict[str, Any]:
        """JAX's ``quantize_lm_head`` (:318-330): the head's calibration
        input is the final norm of the last layer's stream ``x``; its clip
        search (no scale search), then int4 packing."""
        dev = self.device
        head = {"lm_head": to_device(self.params["lm_head"], dev)}
        hin = modules.norm(self.cfg, to_device(self.params["norm"], dev), x)
        if self.do_clip:
            mv = self._search_best_clip(head["lm_head"]["kernel"], hin)
            scale_mod.apply_clip(head, "lm_head", mv)
            self.all_clips.append([("lm_head", mv.cpu())])
        return quantize_linear_params(head["lm_head"], self.qcfg)

    def _resume_path(self, layer: int) -> Optional[str]:
        if self.resume_dir is None:
            return None
        os.makedirs(self.resume_dir, exist_ok=True)
        return os.path.join(self.resume_dir, f"layer_{layer:04d}.pt")

    def pack(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Pack an ``export_compatible`` result, on the device its weights
        are on."""
        out = _clone(params)
        for lp in out["layers"]:
            for path in self._quantizable(lp):
                p = get_by_path(lp, path)
                if "kernel" in p:
                    set_by_path(lp, path, quantize_linear_params(p,
                                                                 self.qcfg))
        return out

    # ------------------------------------------------------------------ #

    def _local(self, a):
        """This data rank's contiguous slice of a batch-leading array."""
        if self._data is None:
            return a
        n = len(a) // self._ddp
        return a[self._data.index * n:(self._data.index + 1) * n]

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """A batch reduction's local sum, summed over the data group."""
        return t if self._data is None else pd.all_reduce(t, self._data)

    def _chunk_size(self, b: int) -> Optional[int]:
        """Largest divisor of the sample count ``b`` (the whole batch, all
        data ranks') <= n_parallel_calib_samples (None: no chunking); under
        data-parallel calibration chunks also split evenly over the
        ``data`` axis (JAX's ``_chunk_size``)."""
        c = self.n_parallel
        if not c or c >= b:
            return None
        c = max(1, min(c, b))
        while b % c or c % self._ddp:
            c -= 1
            if c < self._ddp:
                return None
        return c

    def _local_chunk(self, b: int) -> Optional[int]:
        """The chunk of a rank's ``b`` local samples: its share of
        :meth:`_chunk_size` of the whole batch."""
        c = self._chunk_size(b * self._ddp)
        return None if c is None else c // self._ddp

    def _offload(self, t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Recorded inputs to host memory, one copy per distinct tensor
        (q, k and v record the same one)."""
        host: Dict[int, torch.Tensor] = {}
        for v in t.values():
            if id(v) not in host:
                host[id(v)] = v.cpu()
        return {k: host[id(v)] for k, v in t.items()}

    def _block_tapped(self, lp, x, cos, sin, mask,
                      taps: Dict) -> torch.Tensor:
        """The layer's forward with taps; returns the next layer's input
        and fills ``taps``. With ``n_parallel_calib_samples`` the samples
        run in chunks; with ``offload_taps`` each chunk's recorded inputs go
        to host memory at once."""
        def run(xc, lo):
            t: Dict[str, torch.Tensor] = {}
            y, _ = modules.block(self.cfg, lp, xc, _rows(cos, lo, len(xc)),
                                 _rows(sin, lo, len(xc)), mask,
                                 method="plain", taps=t)
            return y, (self._offload(t) if self.offload_taps else t)

        b = x.shape[0]
        c = self._local_chunk(b)
        if c is None:
            y, t = run(x, 0)
            taps.update(t)
            return y
        ys, chunk_taps = [], []
        for lo in range(0, b, c):
            yc, tc = run(x[lo:lo + c], lo)
            ys.append(yc)
            chunk_taps.append(tc)
        # one concatenation per distinct tensor, releasing the chunks' pieces
        # as it goes (holding them all would double the taps' footprint)
        done: Dict[Tuple[int, ...], torch.Tensor] = {}
        for name in list(chunk_taps[0]):
            key = tuple(id(tc[name]) for tc in chunk_taps)
            if key not in done:
                done[key] = torch.cat([tc[name] for tc in chunk_taps])
            taps[name] = done[key]
            for tc in chunk_taps:
                del tc[name]
        return torch.cat(ys)

    def _inspect(self, group: ScaleGroup):
        """The group's module, run over sample chunks where
        ``n_parallel_calib_samples`` asks (the intermediates stay bounded)."""
        inspect = make_inspect_fn(self.cfg, group, self.out_features_map)

        def run(lp, x, cos, sin, mask):
            c = self._local_chunk(x.shape[0]) if x.dim() >= 3 else None
            if c is None:
                return inspect(lp, x, cos, sin, mask)
            return torch.cat([inspect(lp, x[lo:lo + c], _rows(cos, lo, c),
                                      _rows(sin, lo, c), mask)
                              for lo in range(0, x.shape[0], c)])
        return run

    def _search_best_scale(self, lp, group: ScaleGroup, taps, cos, sin,
                           mask) -> Tuple[torch.Tensor, int, List[float]]:
        """The 20-point grid over the ratio: returns (scales [K] f32, the
        chosen grid index, every grid point's loss)."""
        inp = taps.get(group.inp)
        if inp is None:
            raise KeyError(f"tap {group.inp} missing; have {list(taps)}")
        inp = inp.to(self.device)
        inspect = self._inspect(group)
        qz, g, bits = (self.qcfg.zero_point, self.qcfg.q_group_size,
                       self.qcfg.w_bit)
        layers = [get_by_path(lp, p) for p in group.layers]
        w_cat = torch.cat([p["kernel"].float() for p in layers], dim=1)
        k = w_cat.shape[0]
        gs = g if g > 0 else k
        # per-group normalised |w| channel mean
        wg = w_cat.abs().reshape(k // gs, gs, -1)
        wg = wg / (wg.amax(dim=1, keepdim=True) + 1e-6)
        w_mean = wg.reshape(k, -1).mean(dim=1)
        flat = inp.reshape(-1, k)
        t_tot = flat.shape[0]
        rows = (t_tot if self.max_chunk_memory is None
                else max(1, self.max_chunk_memory // (4 * k)))
        if rows >= t_tot and self._data is None:
            x_mean = flat.float().abs().mean(0)
        else:  # a byte-budgeted sum of chunk sums: the same mean
            acc = torch.zeros(k, dtype=torch.float32, device=self.device)
            for s0 in range(0, t_tot, rows):
                acc = acc + flat[s0:s0 + rows].float().abs().sum(0)
            x_mean = self._sum(acc) / (t_tot * self._ddp)
        fp_out = inspect(lp, inp, cos, sin, mask).float()

        def compute_scales(ratio: torch.Tensor) -> torch.Tensor:
            if self.duo_scaling:
                s = torch.clamp(x_mean ** ratio
                                / (w_mean ** (1 - ratio) + 1e-4), min=1e-4)
            else:
                s = torch.clamp(x_mean ** ratio, min=1e-4)
            s = s / torch.sqrt(s.max() * s.min())
            return torch.where(torch.isfinite(s), s, torch.ones_like(s))

        ratios = (torch.arange(self.n_grid, dtype=torch.float32,
                               device=self.device) / self.n_grid)
        losses = []
        for ratio in ratios:
            s = compute_scales(ratio)
            lp2 = _clone(lp)
            for path in group.layers:
                fc = dict(get_by_path(lp2, path))
                w2 = fc["kernel"].float() * s[:, None]
                w2 = pseudo_quantize_weight(w2, bits=bits, group_size=g,
                                            zero_point=qz) / s[:, None]
                fc["kernel"] = w2.to(inp.dtype)
                set_by_path(lp2, path, fc)
            out = inspect(lp2, inp, cos, sin, mask).float()
            if self._data is None:
                losses.append(torch.mean((fp_out - out) ** 2))
            else:
                losses.append(torch.sum((fp_out - out) ** 2))
        losses = torch.stack(losses)
        if self._data is not None:  # the whole batch's mean
            losses = self._sum(losses) / (fp_out.numel() * self._ddp)
        # a NaN loss is never chosen (JAX's nanargmin)
        best = int(torch.argmin(torch.nan_to_num(losses, nan=float("inf"))))
        return compute_scales(ratios[best]), best, losses.tolist()

    def _search_best_clip(self, w: torch.Tensor,
                          inp: torch.Tensor) -> torch.Tensor:
        """The clip grid: for each group and column, the max-val among
        ``max_clip_shrink * n_grid`` shrinks of the group's |w| max whose
        pseudo-quantized product with a token sample is closest to the
        float one. Returns [K // g, N]."""
        k, n = w.shape
        g = self.qcfg.q_group_size if self.qcfg.q_group_size > 0 else k
        bits, qz = self.qcfg.w_bit, self.qcfg.zero_point
        n_steps = int(self.max_clip_shrink * self.n_grid)
        n_chunk = 256 if n % 256 == 0 else (64 if n % 64 == 0 else n)
        t_total = int(np.prod(inp.shape[:-1]))  # this rank's tokens
        t_all = t_total * self._ddp
        step = max(1, t_all // self.n_clip_sample_tokens)
        n_sample = -(-t_all // step)  # rows of the whole batch's [::step]
        if self.max_chunk_memory is not None:
            # bound the column chunk so the search's two [T', K/g, nc] f32
            # buffers fit the byte budget
            nc_max = max(1, self.max_chunk_memory
                         // (8 * n_sample * max(k // g, 1)))
            cand = [c for c in (256, 128, 64, 32, 16, 8, 4, 2, 1)
                    if n % c == 0 and c <= min(nc_max, n_chunk)]
            if cand:
                n_chunk = cand[0]
        # the rows of the whole batch's [::step] that fall in this rank's
        # slice of it (all of them in one process)
        first = 0 if self._data is None else (
            -self._data.index * t_total) % step
        x = inp.reshape(-1, k)[first::step].to(self.device).float()
        xg = x.reshape(x.shape[0], k // g, g).transpose(0, 1)  # [K/g, T', g]

        best = []
        for c0 in range(0, n, n_chunk):
            wgrp = w[:, c0:c0 + n_chunk].float().reshape(k // g, g, -1)
            org_max = wgrp.abs().amax(dim=1)  # [K/g, nc]
            org_out = torch.bmm(xg, wgrp)  # [K/g, T', nc]
            best_max = org_max
            min_err = torch.full_like(org_max, 1e9)
            errs = []
            for i_s in range(n_steps):
                mv = org_max * (1 - i_s / self.n_grid)
                cur = torch.clamp(wgrp, -mv[:, None, :], mv[:, None, :])
                qw = pseudo_quantize_weight(
                    cur.reshape(k, -1), bits=bits, group_size=g,
                    zero_point=qz).reshape(k // g, g, -1)
                d2 = (torch.bmm(xg, qw) - org_out) ** 2
                errs.append(d2.mean(dim=1) if self._data is None
                            else d2.sum(dim=1))
            if self._data is not None:  # one all-reduce for the chunk
                errs = list(self._sum(torch.stack(errs)) / n_sample)
            for i_s, err in enumerate(errs):
                mv = org_max * (1 - i_s / self.n_grid)
                better = err < min_err
                min_err = torch.where(better, err, min_err)
                best_max = torch.where(better, mv, best_max)
            best.append(best_max)
        return torch.cat(best, dim=1)

    def _quantizable(self, lp) -> List[str]:
        """The plugin's quantizable paths minus ``modules_to_not_convert``."""
        return [path for path in self.plugin.quantizable(self.cfg, lp)
                if not any(skip in path for skip in self._skip)]


def save_layer_ckpt(path: str, lp: Dict[str, Any], x: torch.Tensor) -> None:
    """One finished layer's resume file: its packed tree and the activation
    stream after it, as CPU tensors (a host copy of a layer kept on the
    device), by ``torch.save`` to a temporary name, then ``os.replace`` (a
    crash leaves no half-written file)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"layer": to_device(lp, "cpu"), "x": x.detach().cpu()}, tmp)
    os.replace(tmp, path)


def load_layer_ckpt(path: str) -> Tuple[Dict[str, Any], torch.Tensor]:
    """(layer tree, activation stream) of a resume file, on the CPU."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return data["layer"], data["x"]
