"""ACL-GAN trainer: networks, optimizers and the train step, NCHW.

Port of `aclgan_tpu/trainer.py` (`to_model_range`, `ACLGAN`: `init_state`,
`learning_rate`, `generator_forward`, the D and G updates, `train_step`,
`translate`, `sample`), plus `snapshot` / `restore`, the state that
`utils/checkpoint.py` writes and reads. What differs from the JAX package, by design:

- State lives on the object (the networks, two Adams, the EMA copies and the
  global `step`), and `train_step` updates it in place; the JAX step is a pure
  function of a `TrainState` pytree.
- z is drawn from one `torch.Generator` on the device, seeded at
  `init_state`; it cannot reproduce the JAX `fold_in` stream, so the tests
  inject the JAX draws through `train_step(z=...)`.
- Params stay float32; each conv/dense casts to `cfg.tpu.compute_dtype`
  itself (no autocast), as flax's `dtype=` does.
- `tpu.remat` wraps the G step's encoder / decoder calls in
  `torch.utils.checkpoint` (non-reentrant) where the JAX step uses
  `jax.checkpoint`; `tpu.grad_accum` runs the strided micro-batches one after
  another, summing gradients, where the JAX step scans them;
  `tpu.moment_dtype: bfloat16` keeps `optim.Adam`'s first moments in bf16.
- Where the JAX package jits `train_step` and `sample`, the port records
  them on a CUDA device into one CUDA graph per key and replays them
  (`graphs.StepGraphs`): the step by (do_dis, do_gen, batch shapes, z
  injected or drawn), `sample` by its inputs' shapes and dtypes.
  `step_increment` stays on the host, which writes the learning rate of the
  step into the optimizers' lr tensors before each call. The step body reads
  nothing back to the host and holds every collective of the step under a
  mesh: the gradients' and the metrics' all-reduces, the focus sums, bn's
  statistics, and under a `SpatialMesh` the halos and the split kernels'
  all-reduces. An NCCL `DataMesh` (`torchrun --nproc_per_node N`) and an
  NCCL spatial grid of any size (`mesh.capturable()`) replay it as a
  graph; the capture checks the key and its success across the mesh's
  ranks and raises on every rank when the keys differ or a rank's capture
  fails. A graph holds its collectives' communicators until it is
  destroyed, so a rank calls `release_graphs` before its process group
  goes (the train CLI does, on every exit path).
  The steps run eagerly on the CPU, under a gloo mesh
  (gloo stages its collectives through the host), under `tpu.check_nans`
  (anomaly mode cannot be captured), or when built with `graphs=False`; the
  model prints which when it is built. `sample` is graphed where the step
  is, outside a `SpatialMesh`.
- Data parallelism (`mesh`, one process a GPU; `parallel/mesh.py`): each
  rank steps on its rows of the global batch and draws the global z, keeping
  its rows; bn's batch statistics and the focus loss's batch sums are
  all-reduced in the forward, so every loss is the global batch's; after the
  backward each network's gradient is averaged over the ranks in one flat
  all-reduce, and the metrics are averaged inside the step. The step
  equals the single-process step on the gathered batch, as GSPMD makes the
  JAX one.
- Spatial sharding (a `parallel.spatial.SpatialMesh`, n_data x n_spatial
  ranks): a rank holds its data index's rows and its H-slice of each image.
  The layers exchange halo rows and all-reduce their statistics over the
  spatial group (the mesh is set on them here), bn's over the grid. Each
  rank's losses are means over its own elements; the shards are equal, so
  the step's loss is their mean over the grid, which the same world
  all-reduce of gradients and metrics takes. A term computed from sums
  all-reduced over the grid (the focus size and digit terms) is equal on
  every rank, and the mean counts it once.

Calls to the same network are batched along dim 0 (every generator norm is
per sample), image pairs for the consistency discriminator along channels.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from aclgan_tpu_torch import losses
from aclgan_tpu_torch.config import Config
from aclgan_tpu_torch.graphs import StepGraphs
from aclgan_tpu_torch.models.discriminator import MsDiscriminator
from aclgan_tpu_torch.models.generator import AdaINGenerator
from aclgan_tpu_torch.optim import Adam
from aclgan_tpu_torch.parallel.mesh import (DataMesh, all_reduce_mean, all_reduce_sum,
                                            batch_sharding)
from aclgan_tpu_torch.parallel.spatial import SpatialMesh, data_rows

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEN_NAMES = ("AB", "BA")
DIS_NAMES = ("A", "B", "2")
Metrics = Dict[str, torch.Tensor]
ZTriple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device must exist (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def compute_dtype(cfg: Config) -> torch.dtype:
    name = cfg.tpu.compute_dtype
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype {name!r} not supported ({sorted(_DTYPES)})")
    return _DTYPES[name]


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32 in [-1, 1]; float inputs pass through."""
    if x.is_floating_point():
        return x
    return x.float() * (2.0 / 255.0) - 1.0


def _remat_families(remat: Any) -> FrozenSet[str]:
    """The generator calls `tpu.remat` recomputes (`aclgan_tpu/trainer.py:201-210`)."""
    if remat in (False, "", None, "none"):
        return frozenset()
    if remat in (True, "all"):
        return frozenset({"encode", "decode"})
    if remat in ("encode", "decode"):
        return frozenset({remat})
    raise ValueError(f"tpu.remat must be bool|'all'|'encode'|'decode', got {remat!r}")


def _micro_batches(x: torch.Tensor, accum: int) -> List[torch.Tensor]:
    """The strided split of `aclgan_tpu/trainer.py:490-514`: micro-batch m
    takes the samples whose index % accum == m."""
    if x.shape[0] % accum:
        raise ValueError(f"batch_size {x.shape[0]} not divisible by tpu.grad_accum {accum}")
    return [x[m::accum] for m in range(accum)]


class ACLGAN:
    """Holds `gen_AB` / `gen_BA` (both built on input_dim_a channels) with
    float32 params, computing in `cfg.tpu.compute_dtype`. `init_state` adds
    what training needs: `dis_A` / `dis_B` / `dis_2`, the optimizers, the EMA
    and the step; serving builds only the generators. With a `mesh`, the
    train step is one rank's share of a data-parallel step, and under a
    `SpatialMesh` the train step and `translate` take this rank's H-slice.
    `graphs` False keeps every step eager on a CUDA device too (`graphs` is
    then None; the checks compare the two forms so)."""

    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda",
                 seed: Optional[int] = None,
                 mesh: Optional[Union[DataMesh, SpatialMesh]] = None,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        eager = self._eager_reason(graphs)
        self.graphs = None if eager else StepGraphs(self.device)
        if eager:
            print(f"ACLGAN: steps run eagerly ({eager})")
        self._metric_names: Dict[Tuple[bool, bool], List[str]] = {}
        self.dtype = compute_dtype(cfg)
        self.use_focus = cfg.use_focus
        self.seed = cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(self.seed)

        def make():
            return AdaINGenerator(cfg.gen, cfg.data.input_dim_a, cfg.init, self.dtype,
                                  gen).to(self.device)

        self.gen_AB = make()
        self.gen_BA = make()
        for name in GEN_NAMES:
            self._set_mesh(f"gen_{name}", self.gen(name))
        # the VGG perceptual loss's network, loaded when vgg_w > 0 as the JAX
        # trainer does; like it (and the reference), the step adds no VGG term
        self.vgg = None
        if cfg.vgg_w > 0:
            from aclgan_tpu_torch.models.vgg import load_vgg16

            weights = None
            if cfg.vgg_model_path:
                cand = os.path.join(cfg.vgg_model_path, "models", "vgg16.weight")
                weights = cand if os.path.exists(cand) else None
            self.vgg = load_vgg16(weights, dtype=self.dtype, device=self.device)
        self.remat = _remat_families(cfg.tpu.remat)
        self.accum = max(1, int(cfg.tpu.grad_accum))  # as the JAX step reads it
        if cfg.tpu.moment_dtype not in _DTYPES:
            raise ValueError(f"tpu.moment_dtype {cfg.tpu.moment_dtype!r} not supported "
                             f"({sorted(_DTYPES)})")

    def _eager_reason(self, graphs: bool) -> Optional[str]:
        """Why the steps cannot be CUDA graphs here, or None."""
        if not graphs:
            return "graphs=False"
        if self.device.type != "cuda":
            return f"no CUDA graphs on {self.device.type}"
        if self.mesh is not None and not self.mesh.capturable():
            return (f"a {type(self.mesh).__name__} over gloo: its collectives are staged "
                    f"through the host")
        if self.cfg.tpu.check_nans:
            return "tpu.check_nans: anomaly mode cannot be captured"
        return None

    def release_graphs(self) -> None:
        """Destroy the steps' CUDA graphs (`StepGraphs.release`; nothing
        without graphs). A rank calls it before its process group is
        destroyed: a live graph's collectives hold their communicators, and
        the group's destroy waits for them. The model stays usable: its
        next steps capture again."""
        if self.graphs is not None:
            self.graphs.release()

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> None:
        """Build the training state (`aclgan_tpu/trainer.py:150-190`): the three
        discriminators (gaussian init; dis_2 sees input_dim_b channels), one
        Adam over both generators and one over the discriminators (coupled L2
        weight decay; `optim.Adam`, its first moments bf16 under
        `tpu.moment_dtype: bfloat16`), the EMA copies when
        `tpu.ema_decay > 0`, step 0, and the z generator. Discriminator
        weights draw from seed + 1 (the generators took the seed), z from
        the seed on the device."""
        cfg = self.cfg
        seed = self.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed + 1)
        dims = {"A": cfg.data.input_dim_a, "B": cfg.data.input_dim_a,
                "2": cfg.data.input_dim_b}
        for name in DIS_NAMES:
            setattr(self, f"dis_{name}", MsDiscriminator(
                cfg.dis, dims[name], "gaussian", self.dtype, gen).to(self.device))
            self._set_mesh(f"dis_{name}", self.dis(name))
        adam = dict(lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                    weight_decay=cfg.weight_decay)
        self.gen_params = [p for n in GEN_NAMES for p in self.gen(n).parameters()]
        self.dis_params = [p for n in DIS_NAMES for p in self.dis(n).parameters()]
        adam = dict(adam, mu_dtype=_DTYPES[cfg.tpu.moment_dtype])
        self.gen_opt = Adam(self.gen_params, **adam)
        self.dis_opt = Adam(self.dis_params, **adam)
        self.ema_decay = float(cfg.tpu.ema_decay)
        self.ema = None
        if self.ema_decay > 0:  # copies, never views of the live weights
            self.ema = {n: {k: p.detach().clone()
                            for k, p in self.gen(n).named_parameters()}
                        for n in GEN_NAMES}
        self.step = 0
        self.z_gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.graphs is not None:  # they hold the replaced state's tensors
            self.graphs.release()

    def _set_mesh(self, name: str, net: torch.nn.Module) -> None:
        """Set the mesh on the layers that read one (bn: the global batch's
        statistics; ConvBlock, the pools and the discriminator: the halo and
        the spatial group's statistics), each named for the halo's errors."""
        for path, m in net.named_modules():
            if hasattr(m, "mesh"):
                m.mesh = self.mesh
            if hasattr(m, "layer"):
                m.layer = f"{name}.{path}" if path else name

    def compute_vgg_loss(self, img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The perceptual loss on relu5_3 features of two NCHW [-1, 1] batches
        (`aclgan_tpu/trainer.py:128-134`)."""
        if self.vgg is None:
            raise RuntimeError("vgg_w == 0: VGG not loaded")
        from aclgan_tpu_torch.models.vgg import compute_vgg_loss

        return compute_vgg_loss(self.vgg, img, target)

    def reseed_z(self, step: int) -> None:
        """Restart the z stream from (seed, step): a resume whose snapshot
        carries no z generator state (a JAX run's threefry key cannot seed it)."""
        self.z_gen.manual_seed((self.seed * 2**32 + step) % 2**63)

    def gen(self, name: str) -> AdaINGenerator:
        return getattr(self, f"gen_{name}")

    def dis(self, name: str) -> MsDiscriminator:
        return getattr(self, f"dis_{name}")

    # ------------------------------------------------------------------
    def learning_rate(self, step: int) -> float:
        """StepLR stepped every iteration, on the global step (`:140-147`)."""
        cfg = self.cfg
        if cfg.lr_policy == "constant":
            return cfg.lr
        if cfg.lr_policy == "step":
            return cfg.lr * cfg.gamma ** (step // cfg.step_size)
        raise NotImplementedError(f"learning rate policy [{cfg.lr_policy}] is not implemented")

    def _split_img_mask(self, dec_out: torch.Tensor):
        """(N, C, H, W) decoder output -> (rgb, mask or None)."""
        if self.use_focus:
            return dec_out[:, :3], dec_out[:, 3:4]
        return dec_out, None

    def _blend(self, dec_out: torch.Tensor, bg: torch.Tensor):
        """Decoder output -> (image blended over bg by its mask, mask)."""
        img, mask = self._split_img_mask(dec_out)
        if mask is None:
            return img, None
        return losses.focus_translation(img, bg, mask), mask

    def _call(self, family: str, fn: Callable, *args: torch.Tensor) -> torch.Tensor:
        """fn(*args), recomputed in the backward when `tpu.remat` names its
        family and a graph is being recorded. Non-reentrant: the reentrant
        form drops the parameters' gradients when no input requires one (the
        images) and refuses `torch.autograd.grad`. No RNG runs inside, so its
        state is not saved."""
        if family in self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def generator_forward(self, x_a: torch.Tensor, x_b: torch.Tensor, z1: torch.Tensor,
                          z2: torch.Tensor, z3: torch.Tensor,
                          with_recon: bool) -> Dict[str, Optional[torch.Tensor]]:
        """The shared translation graph (`:284-372`), NCHW in [-1, 1]. The D
        step (with_recon False) encodes no x_b and no styles."""
        b = x_a.shape[0]
        d = self.dtype
        x_a, x_b = x_a.to(d), x_b.to(d)
        g_ab, g_ba = self.gen_AB, self.gen_BA
        call = self._call
        if with_recon:
            c_ab = call("encode", g_ab.encode_content, torch.cat([x_a, x_b], 0))
            c_1, c_4 = c_ab[:b], c_ab[b:]
            s_4 = call("encode", g_ab.encode_style, x_b)
            c_2 = call("encode", g_ba.encode_content, x_a)
            s_2 = call("encode", g_ba.encode_style, x_a)
        else:
            c_1 = call("encode", g_ab.encode_content, x_a)
            c_2 = call("encode", g_ba.encode_content, x_a)
        z1, z2, z3 = z1.to(d), (self.cfg.alpha * z2).to(d), z3.to(d)  # alpha: z2 only

        if with_recon:
            dec_ab = call("decode", g_ab.decode, torch.cat([c_1, c_4], 0),
                          torch.cat([z1, s_4], 0))
            dec_B, dec_B_recon = dec_ab[:b], dec_ab[b:]
        else:
            dec_B = call("decode", g_ab.decode, c_1, z1)
        x_B_fake, x_B_mask = self._blend(dec_B, x_a)

        c_3 = call("encode", g_ba.encode_content, x_B_fake)
        contents = [c_2, c_3] + ([c_2] if with_recon else [])
        styles = [z2, z3] + ([s_2] if with_recon else [])
        dec_ba = call("decode", g_ba.decode, torch.cat(contents, 0), torch.cat(styles, 0))
        x_A_fake, x_A_mask = self._blend(dec_ba[:b], x_a)
        x_A2_fake, x_A2_mask = self._blend(dec_ba[b:2 * b], x_B_fake)

        out = {
            "x_B_fake": x_B_fake, "x_A_fake": x_A_fake, "x_A2_fake": x_A2_fake,
            "x_B_mask": x_B_mask, "x_A_mask": x_A_mask, "x_A2_mask": x_A2_mask,
            # channel-concat pairs for the consistency discriminator
            "pair_A1": torch.cat([x_a, x_A_fake], 1),
            "pair_A2": torch.cat([x_a, x_A2_fake], 1),
        }
        if with_recon:
            # identity recons are the raw first 3 channels, never blended
            out["x_A_recon"] = dec_ba[2 * b:, :3]
            out["x_B_recon"] = dec_B_recon[:, :3]
        return out

    # ------------------------------------------------------------------
    def _dis_loss(self, fwd, x_a: torch.Tensor, x_b: torch.Tensor
                  ) -> Tuple[torch.Tensor, Metrics]:
        """D losses (`:380-419`), one forward per discriminator."""
        cfg, b, gt = self.cfg, x_a.shape[0], self.cfg.dis.gan_type
        x_a, x_b = x_a.to(self.dtype), x_b.to(self.dtype)
        outs = self.dis_A(torch.cat([fwd["x_A_fake"], fwd["x_A2_fake"], x_a], 0))
        real_a = [o[2 * b:] for o in outs]
        loss_A = 0.5 * (losses.dis_loss([o[:b] for o in outs], real_a, gt)
                        + losses.dis_loss([o[b:2 * b] for o in outs], real_a, gt))
        outs = self.dis_B(torch.cat([fwd["x_B_fake"], x_b], 0))
        loss_B = losses.dis_loss([o[:b] for o in outs], [o[b:] for o in outs], gt)
        # dis_2: pair2 plays "real", pair1 "fake" (trainer.py:286)
        outs = self.dis_2(torch.cat([fwd["pair_A1"], fwd["pair_A2"]], 0))
        loss_2 = losses.dis_loss([o[:b] for o in outs], [o[b:] for o in outs], gt)
        total = cfg.gan_w * loss_A + cfg.gan_w * loss_B + cfg.gan_cw * loss_2
        return total, {"loss_dis_A": loss_A, "loss_dis_B": loss_B,
                       "loss_dis_2": loss_2, "loss_dis_total": total}

    def _gen_loss(self, x_a: torch.Tensor, x_b: torch.Tensor, z: ZTriple
                  ) -> Tuple[torch.Tensor, Metrics]:
        """G losses (`:421-478`) against the discriminators as they stand."""
        cfg, b, gt = self.cfg, x_a.shape[0], self.cfg.dis.gan_type
        fwd = self.generator_forward(x_a, x_b, *z, with_recon=True)
        outs = self.dis_A(torch.cat([fwd["x_A_fake"], fwd["x_A2_fake"]], 0))
        adv_A = 0.5 * (losses.gen_loss([o[:b] for o in outs], gt)
                       + losses.gen_loss([o[b:] for o in outs], gt))
        adv_B = losses.gen_loss(self.dis_B(fwd["x_B_fake"]), gt)
        outs = self.dis_2(torch.cat([fwd["pair_A1"], fwd["pair_A2"]], 0))
        adv_2 = losses.gen_d2_loss([o[:b] for o in outs], [o[b:] for o in outs], gt)
        total = cfg.gan_w * adv_A + cfg.gan_w * adv_B + cfg.gan_cw * adv_2
        metrics = {"loss_gen_adv_A": adv_A, "loss_gen_adv_B": adv_B,
                   "loss_gen_adv_2": adv_2}
        if self.use_focus:
            # masks mapped to [0,1], then size + digit terms over H*W*B*3; the
            # terms' sums run over the global batch (every rank of the grid,
            # whose world = n_data * n_spatial makes `norm` the global H*W*B*3)
            batch_sum = torch.sum if self.mesh is None else self._global_sum
            world = 1 if self.mesh is None else self.mesh.world
            norm = x_a.shape[2] * x_a.shape[3] * b * world * 3
            focus_total = 0.0
            for name in ("B", "A", "A2"):
                m01 = (fwd[f"x_{name}_mask"].float() + 1.0) * 0.5
                size_l = losses.focus_size_loss(m01, cfg.focus_upper, cfg.focus_lower,
                                                cfg.focus_delta, batch_sum)
                digit_l = losses.focus_digit_loss(m01, cfg.focus_epsilon, batch_sum)
                metrics[f"loss_gen_focus_{name}_size"] = size_l
                metrics[f"loss_gen_focus_{name}_digit"] = digit_l
                focus_total = focus_total + size_l + digit_l
            total = total + cfg.focus_loss * focus_total / norm
        idt_A = losses.l1_loss(fwd["x_A_recon"], x_a)
        idt_B = losses.l1_loss(fwd["x_B_recon"], x_b)
        total = total + cfg.recon_x_w * idt_A + cfg.recon_x_w * idt_B
        metrics.update(loss_idt_A=idt_A, loss_idt_B=idt_B, loss_gen_total=total)
        return total, metrics

    def _global_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(torch.sum(t), self.mesh.world_group)

    def _sync_grads(self, nets: Sequence[torch.nn.Module]) -> None:
        """Average the gradients over the mesh's ranks: one flat all-reduce a
        network."""
        if self.mesh is None:
            return
        for net in nets:
            all_reduce_mean([p.grad for p in net.parameters()], self.mesh)

    def _micro(self, x_a: torch.Tensor, x_b: torch.Tensor, z: ZTriple):
        """(x_a, x_b, z) of each micro-batch: the whole batch when accum is 1."""
        if self.accum == 1:
            return [(x_a, x_b, z)]
        parts = [_micro_batches(t, self.accum) for t in (x_a, x_b, *z)]
        return [(xa, xb, (z1, z2, z3)) for xa, xb, z1, z2, z3 in zip(*parts)]

    def _accumulate(self, loss_fn: Callable, params: List[torch.Tensor], x_a: torch.Tensor,
                    x_b: torch.Tensor, z: ZTriple) -> Metrics:
        """`loss_fn(x_a, x_b, z)`'s gradients for `params`, summed over the
        micro-batches and divided once into `.grad` (`:516-542`); returns the
        micro-batch mean of the metrics."""
        grads, per_micro = None, []
        for xa, xb, zm in self._micro(x_a, x_b, z):
            total, metrics = loss_fn(xa, xb, zm)
            g = torch.autograd.grad(total, params)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            per_micro.append(metrics)
        if self.accum > 1:
            grads = torch._foreach_div(list(grads), float(self.accum))
        held = [p.grad for p in params]
        if any(h is None for h in held):
            for p, g in zip(params, grads):
                p.grad = g
        else:  # into the same buffers each step: a graph's replay writes them too
            torch._foreach_copy_(held, list(grads))
        if len(per_micro) == 1:
            return per_micro[0]
        return {k: torch.stack([m[k] for m in per_micro]).mean(0) for k in per_micro[0]}

    def _dis_step_loss(self, x_a: torch.Tensor, x_b: torch.Tensor, z: ZTriple
                       ) -> Tuple[torch.Tensor, Metrics]:
        with torch.no_grad():
            fwd = self.generator_forward(x_a, x_b, *z, with_recon=False)
        return self._dis_loss(fwd, x_a, x_b)

    def dis_update(self, x_a: torch.Tensor, x_b: torch.Tensor, z: ZTriple) -> Metrics:
        """One discriminator update (`:544-571`); the generators run without
        a graph. bn stats and sn u / v advance on each micro-batch's forwards."""
        metrics = self._accumulate(self._dis_step_loss, self.dis_params, x_a, x_b, z)
        self._sync_grads([self.dis(n) for n in DIS_NAMES])
        self.dis_opt.update()  # at the lr train_step wrote
        return metrics

    def gen_update(self, x_a: torch.Tensor, x_b: torch.Tensor, z: ZTriple) -> Metrics:
        """One generator update (`:573-603`) against the discriminators already
        stepped this iteration. Gradients are taken for the generators' params
        only: the discriminators' weight gradients are never computed (their
        bn stats and sn u / v still advance on these forwards)."""
        metrics = self._accumulate(self._gen_loss, self.gen_params, x_a, x_b, z)
        self._sync_grads([self.gen(n) for n in GEN_NAMES])
        self.gen_opt.update()
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for n in GEN_NAMES:
                    for k, p in self.gen(n).named_parameters():
                        self.ema[n][k].mul_(d).add_(p, alpha=1.0 - d)
        return metrics

    def _draw_z(self, batch: int) -> ZTriple:
        shape = (batch, self.cfg.gen.style_dim)
        return tuple(torch.randn(shape, generator=self.z_gen, device=self.device)
                     for _ in range(3))

    def _images(self, x) -> torch.Tensor:
        """NHWC uint8 or [-1, 1] float -> NCHW float in [-1, 1] on the device."""
        return self._nchw(torch.as_tensor(x).to(self.device))

    @staticmethod
    def _nchw(x: torch.Tensor) -> torch.Tensor:
        """NHWC uint8 or [-1, 1] float already on the device -> NCHW [-1, 1]."""
        return to_model_range(x).permute(0, 3, 1, 2).contiguous()

    def train_step(self, x_a, x_b, do_dis: bool, do_gen: bool, step_increment: int = 1,
                   z: Optional[Dict[str, Sequence]] = None) -> Metrics:
        """One iteration (`:605-642`): the D update, then the G update, each on
        its own z, as the cadence asks. `step_increment` = 1 + the iterations
        the cadence skipped since the last call, so `step` (and the StepLR
        schedule) follows the global iteration. `z` ({"dis": (z1, z2, z3),
        "gen": (...)}, each (B, style_dim)) replaces the draws. Returns the
        metrics as 0-dim tensors under the JAX names, without a host sync.
        On a CUDA device with `graphs`, the step after the host's part (the
        step count, the lr, the batches' copy to the device) is one CUDA
        graph per key, replayed.

        Under a `mesh`, x_a and x_b are this rank's rows of the global batch
        (under a `SpatialMesh`, its data index's rows and its H-slice) and `z`
        is global: each rank keeps its rows of it, as of its own global draw;
        the metrics are the global batch's."""
        if step_increment != 1:
            self.step += step_increment - 1
        if not (do_dis or do_gen):
            self.step += 1
            return {}
        lr = self.learning_rate(self.step)
        self.gen_opt.set_lr(lr)
        self.dis_opt.set_lr(lr)
        x_a, x_b = torch.as_tensor(x_a).to(self.device), torch.as_tensor(x_b).to(self.device)
        if isinstance(self.mesh, SpatialMesh):
            b = x_a.shape[0] * self.mesh.n_data
            rows = data_rows(self.mesh, b)
        else:
            b = x_a.shape[0] * (1 if self.mesh is None else self.mesh.world)
            rows = batch_sharding(self.mesh, b)
        kinds = [k for k, on in (("dis", do_dis), ("gen", do_gen)) if on]
        zs: Tuple[torch.Tensor, ...] = ()
        if z is not None:
            for kind in kinds:
                triple = tuple(torch.as_tensor(v).to(self.device, torch.float32)
                               for v in z[kind])
                if any(v.shape[0] != b for v in triple):
                    raise ValueError(f"z must hold the global batch's {b} rows")
                zs += tuple(v[rows] for v in triple)

        def body(xa: torch.Tensor, xb: torch.Tensor, *zin: torch.Tensor) -> torch.Tensor:
            return self._step(xa, xb, do_dis, do_gen, b, rows, zin)

        if self.graphs is None:
            values = body(x_a, x_b, *zs)
        else:
            key = ("train", do_dis, do_gen, tuple(x_a.shape), x_a.dtype, tuple(x_b.shape),
                   x_b.dtype, z is None)
            values = self.graphs.run(key, (x_a, x_b, *zs), body, (self.z_gen,), self.mesh)
        self.step += 1
        return dict(zip(self._metric_names[(do_dis, do_gen)], values.unbind()))

    def _step(self, x_a: torch.Tensor, x_b: torch.Tensor, do_dis: bool, do_gen: bool,
              b: int, rows, zs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The step body on device batches: the updates, on the z triples in
        `zs` (D's then G's) or on draws from `z_gen` when it is empty; returns
        the metrics stacked (averaged over the mesh's ranks), their names kept
        in `_metric_names`. Device work only: this is what a CUDA graph
        records."""
        x_a, x_b = self._nchw(x_a), self._nchw(x_b)
        triples = iter([tuple(zs[i:i + 3]) for i in range(0, len(zs), 3)])

        def noise() -> ZTriple:
            if zs:
                return next(triples)
            return tuple(v[rows] for v in self._draw_z(b))

        metrics: Metrics = {}
        if do_dis:
            metrics.update(self.dis_update(x_a, x_b, noise()))
        if do_gen:
            metrics.update(self.gen_update(x_a, x_b, noise()))
        self._metric_names[(do_dis, do_gen)] = list(metrics)
        values = torch.stack([v.detach() for v in metrics.values()])
        if self.mesh is not None:
            all_reduce_mean([values], self.mesh)
        return values

    # ------------------------------------------------------------------
    @torch.no_grad()
    def translate(self, x: torch.Tensor, style: torch.Tensor, a2b: bool = True,
                  eval_blend: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Translate NHWC images (uint8 or [-1,1] float) with style codes (N, style_dim).

        Returns NHWC (image, mask or None) in the compute dtype. The JAX
        version runs the full encoder and drops the style; the content
        encoder alone gives the same content code. Under a `SpatialMesh`, x
        is this rank's H-slice of its images, and so is the result.
        """
        gen = self.gen_AB if a2b else self.gen_BA
        x = self._images(x).to(self.dtype)
        content = gen.encode_content(x)
        dec = gen.decode(content, style.to(self.device, self.dtype))
        img, mask = self._split_img_mask(dec)
        if mask is not None:
            blend = losses.focus_translation_eval if eval_blend else losses.focus_translation
            img = blend(img, x.to(img.dtype), mask)
            mask = mask.permute(0, 2, 3, 1)
        return img.permute(0, 2, 3, 1), mask

    @torch.no_grad()
    def sample(self, x_a, x_b, z1, z2, z3) -> Tuple[torch.Tensor, ...]:
        """The display grid's rows (`aclgan_tpu/trainer.py:668-706`) from NHWC
        images (uint8 or [-1, 1] float) and style codes (N, style_dim), with
        the live generators and the train-time blend. Returns NHWC float32:
        (x_a, x_A_fake, mask_A, x_B_fake, mask_B, x_A2_fake, mask_A2,
        x_A_recon, mask_recon) with focus masks, else (x_a, x_A_fake,
        x_B_fake, x_A2_fake, x_A_recon, x_b, x_B_recon). With `graphs`, one
        CUDA graph per input shapes and dtypes, outside a `SpatialMesh`."""
        inputs = tuple(torch.as_tensor(t).to(self.device) for t in (x_a, x_b, z1, z2, z3))
        if self.graphs is None or isinstance(self.mesh, SpatialMesh):
            return self._sample(*inputs)
        key = ("sample",) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        return self.graphs.run(key, inputs, self._sample)

    def _sample(self, x_a, x_b, z1, z2, z3) -> Tuple[torch.Tensor, ...]:
        """`sample` on device tensors: device work only."""
        d = self.dtype
        x_a, x_b = self._nchw(x_a).to(d), self._nchw(x_b).to(d)
        z1, z2, z3 = (z.to(d) for z in (z1, z2, z3))
        g_ab, g_ba = self.gen_AB, self.gen_BA
        b = x_a.shape[0]
        c_1, s_1 = g_ba.encode(x_a)
        c_2 = g_ab.encode_content(x_a)
        if self.use_focus:
            dec = g_ba.decode(torch.cat([c_1, c_1], 0), torch.cat([z1, s_1], 0))
            x_A_fake, mask_A = self._blend(dec[:b], x_a)
            x_A_recon, mask_recon = self._split_img_mask(dec[b:])
            x_B_fake, mask_B = self._blend(g_ab.decode(c_2, z2), x_a)
            x_A2_fake, mask_A2 = self._blend(
                g_ba.decode(g_ba.encode_content(x_B_fake), z3), x_B_fake)
            outs = (x_a, x_A_fake, mask_A, x_B_fake, mask_B, x_A2_fake, mask_A2,
                    x_A_recon, mask_recon)
        else:
            x_A_fake = g_ba.decode(c_1, z1)
            x_A_recon = g_ba.decode(c_1, s_1)
            x_B_fake = g_ab.decode(c_2, z2)
            x_A2_fake = g_ba.decode(g_ba.encode_content(x_B_fake), z3)
            c_4, s_4 = g_ab.encode(x_b)
            outs = (x_a, x_A_fake, x_B_fake, x_A2_fake, x_A_recon, x_b,
                    g_ab.decode(c_4, s_4))
        return tuple(o.permute(0, 2, 3, 1).float() for o in outs)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The training state that `utils/checkpoint.py` writes, as live
        tensors (no copies): the generators', discriminators' and EMA's state
        dicts under the reference key names, both Adams' `state_dict()`, the
        global step and the z generator's state."""
        return {
            "gen": {n: self.gen(n).state_dict() for n in GEN_NAMES},
            "dis": {n: self.dis(n).state_dict() for n in DIS_NAMES},
            "ema": None if self.ema is None else {n: dict(self.ema[n]) for n in GEN_NAMES},
            "gen_opt": self.gen_opt.state_dict(),
            "dis_opt": self.dis_opt.state_dict(),
            "step": self.step,
            "rng": self.z_gen.get_state(),
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        """Load a `snapshot()`-shaped dict into the state `init_state` built.
        An absent ("ema": None) EMA, with EMA on, starts from copies of the
        loaded generator weights; absent optimizer states keep fresh moments;
        an absent "rng" keeps the z stream as seeded. The CUDA graphs are
        dropped: the optimizers' state tensors are replaced."""
        if self.graphs is not None:
            self.graphs.release()
        for n in GEN_NAMES:
            self.gen(n).load_state_dict(snap["gen"][n])
        for n in DIS_NAMES:
            self.dis(n).load_state_dict(snap["dis"][n])
        if self.ema is not None:
            for n in GEN_NAMES:
                live = dict(self.gen(n).named_parameters())
                src = live if snap.get("ema") is None else snap["ema"][n]
                if set(src) != set(live):
                    raise KeyError(f"EMA {n}: keys {sorted(set(src) ^ set(live))[:5]} "
                                   "differ from the generator's parameters")
                with torch.no_grad():
                    for k, t in self.ema[n].items():
                        t.copy_(src[k])
        for opt, key in ((self.gen_opt, "gen_opt"), (self.dis_opt, "dis_opt")):
            if snap.get(key) is not None:
                opt.load_state_dict(snap[key])
        self.step = int(snap["step"])
        if snap.get("rng") is not None:
            self.z_gen.set_state(snap["rng"])
