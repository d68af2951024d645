"""Network lifecycle: build, evaluate, train, checkpoint — the port of
alphazero_general_tpu/models/wrapper.py (reference:
alphazero/NNetWrapper.py:86-282).

* The loss is the policy cross-entropy plus ``value_loss_weight`` times the
  value cross-entropy, both against target distributions
  (NNetWrapper.py:234-238).
* The optimizer is ``torch.optim.SGD`` (momentum, weight decay, nesterov
  from ``optimizer_args``): grad + wd·p, then the momentum buffer, then
  p −= lr·buf, the order the JAX package's optax chain copies. The learning
  rate follows ``multistep_lr`` once per training iteration.
* Device symmetries: with ``set_device_symmetries(env)`` each sample of a
  batch is replaced by its ``sym_idx``-th symmetric image on the device.
* Window mode: with ``set_device_window(True)`` a batch is the
  ``DeviceWindow``'s buffers plus row indices, gathered on the device.
* Checkpoints are saved in the port's own format: ``<name>.ckpt`` is a
  ``torch.save`` of the model's and the optimizer's state dicts and the step
  count, ``<name>.json`` the args. ``load_checkpoint`` also reads the JAX
  package's (``flax.serialization.to_bytes`` of its ``NetState``): params,
  batch statistics, the optax trace as SGD's momentum buffers, and step.
* ``quantized_inference`` builds the int8 tower (models/quant.py) from the
  current weights, the JAX package's ``quant_selfplay`` path.
* Data parallelism (``attach_mesh``; parallel/mesh.py): rank 0's weights
  are broadcast to every rank then and after every load, each step's
  gradients and losses are averaged over the ranks in one ``all_reduce``
  (each rank trains on its share of the global batch), and the int8
  tower's calibration maxima are the maxima over the ranks, so every rank
  quantizes to the same scales.
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from typing import Iterable, Tuple

import numpy as np
import torch

from alphazero_general_tpu_torch.models.architectures import build_model
from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.utils.config import (
    Args, get_args, load_args_file, save_args_file,
)
from alphazero_general_tpu_torch.utils.convert import state_dict_from_jax
from alphazero_general_tpu_torch.utils.flax_bytes import from_bytes

#: The first bytes of a ``torch.save`` file (a zip archive).
_TORCH_MAGIC = b"PK"

#: Train steps enqueued ahead of the oldest loss the host reads back.
PIPE = 16


def multistep_lr(base_lr: float, milestones, gamma: float,
                 iteration: int) -> float:
    """MultiStepLR stepped once per training iteration
    (reference: Coach.py:89-98, NNetWrapper.py:197-200)."""
    passed = sum(1 for m in milestones if iteration >= m)
    return base_lr * (gamma ** passed)


class NNetWrapper:
    """One network on ``device``, in eval mode between train calls."""

    def __init__(self, env, args: Args, device="cuda"):
        self.env = env
        self.args = args
        self.device = torch.device(device)
        self.value_size = env.NUM_PLAYERS + int(env.HAS_DRAW)
        # Random initial weights made from args.seed, without touching the
        # process-wide generator.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(args.get("seed", 0)))
            model = build_model(env, args)
        self.model = model.to(self.device)
        if str(args.get("optimizer", "sgd")) != "sgd":
            raise ValueError(f"optimizer {args.optimizer!r} is not ported "
                             "yet (only 'sgd')")
        opt = args.get("optimizer_args", Args())
        self.optimizer = torch.optim.SGD(
            self.model.parameters(), lr=float(args.get("lr", 1e-2)),
            momentum=float(opt.get("momentum", 0.0)),
            weight_decay=float(opt.get("weight_decay", 0.0)),
            nesterov=bool(opt.get("nesterov", False)))
        self.step = 0
        #: The int8 tower of ``quantized_inference``, re-quantized in place.
        self.quant_model = None
        self._sym_env = None
        self._window_mode = False
        #: Set by ``attach_mesh``: training runs data-parallel.
        self.mesh = False
        self.l_pi = 0.0
        self.l_v = 0.0

    def attach_mesh(self) -> None:
        """Train data-parallel over the process group (JAX
        wrapper.py:92-107): rank 0's weights and statistics on every rank
        now and after every load, gradients averaged over the ranks before
        each optimizer step."""
        self.mesh = M.is_distributed()
        if self.mesh:
            M.replicate_module(self.model)

    def load_jax_variables(self, variables) -> None:
        """Load flax ``{"params", "batch_stats"}`` (numpy leaves) converted
        by utils/convert.py."""
        self.model.load_state_dict(state_dict_from_jax(variables))

    # ------------------------------------------------------------------ eval
    @torch.inference_mode()
    def process(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched eval → (policy probs [B, A], value probs [B, V])
        (NNetWrapper.py:225-232)."""
        logp, logv = self.model(obs)
        return torch.exp(logp), torch.exp(logv)

    def make_eval_fn(self):
        """EvalFn over the current weights, for the search."""
        return self.process

    def quantized_inference(self, calib_obs=None, generator=None,
                            actions=None):
        """The int8 tower of the current weights (JAX wrapper.py:202-232):
        a ``QuantResNet`` on the wrapper's device whose ``forward(obs)``
        gives ``(log_pi, log_v)`` as the model's does. Its activation
        scales are calibrated on ``calib_obs`` (float32 observations), else
        on random playouts drawn from ``generator`` (default: seeded with
        ``args.seed``) or taken from ``actions``. One module per wrapper,
        re-quantized in place by each call, so runners built over it
        follow. Raises ValueError, before any playout, for architectures
        without an int8 path (the FC net, GroupNorm towers)."""
        from alphazero_general_tpu_torch.models.quant import (
            calibration_observations, check_quantizable, quantize_resnet,
        )

        check_quantizable(self.model)
        if calib_obs is None:
            if generator is None and actions is None:
                generator = torch.Generator(self.device).manual_seed(
                    int(self.args.get("seed", 0)))
            calib_obs = calibration_observations(
                self.env, generator=generator, actions=actions,
                device=self.device)
        # Data-parallel: the scales are those of every rank's calibration
        # set (each calibration maximum is the max over the ranks).
        self.quant_model = quantize_resnet(
            self.model, calib_obs.to(self.device, torch.float32),
            out=self.quant_model,
            reduce=M.all_reduce_max if self.mesh else None)
        return self.quant_model

    # ----------------------------------------------------------------- train
    def set_device_symmetries(self, env) -> None:
        """Train on raw batches ``(obs, pi, value, sym_idx)``: each sample
        is replaced by its ``sym_idx``-th symmetric image on the device
        (wrapper.py:109-134). ``env=None`` (or an env without symmetries)
        restores plain ``(obs, pi, value)`` batches."""
        if env is not None and getattr(env, "NUM_SYMMETRIES", 1) <= 1:
            env = None
        self._sym_env = env

    def set_device_window(self, enabled: bool) -> None:
        """Window mode (selfplay/device_window.py): batches become
        ``(obs_buf, pi_buf, val_buf, idx[, sym_idx])``, the window's device
        buffers and the rows to gather from them."""
        self._window_mode = bool(enabled)

    def _to_device(self, x) -> torch.Tensor:
        """A host array or tensor on the device, copied without making the
        host wait (pinned staging) when the device is a GPU."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.device == self.device:
            return x
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _prep_batch(self, batch):
        """(obs, pi, value) float32 on the device: rows gathered from the
        window's buffers in window mode, then, with device symmetries,
        each sample's ``sym_idx``-th symmetric image (wrapper.py:136-158)."""
        if self._window_mode:
            obs_buf, pi_buf, val_buf, idx = batch[:4]
            idx = self._to_device(idx).long()
            batch = (obs_buf[idx], pi_buf[idx], val_buf[idx]) + tuple(
                self._to_device(x) for x in batch[4:])
        else:
            batch = tuple(self._to_device(x) for x in batch)
        obs, pi, value = (x.to(torch.float32) for x in batch[:3])
        if self._sym_env is not None and len(batch) == 4:
            o_s, p_s = self._sym_env.symmetries(obs, pi)
            b = torch.arange(obs.shape[0], device=obs.device)
            sym = batch[3].long()
            obs, pi = o_s[b, sym], p_s[b, sym]
        return obs, pi, value

    def _train_step(self, batch, lr: float):
        obs, target_pi, target_v = self._prep_batch(batch)
        logp, logv = self.model(obs)
        l_pi = -(target_pi * logp).sum(dim=-1).mean()
        l_v = -(target_v * logv).sum(dim=-1).mean() \
            * float(self.args.value_loss_weight)
        self.optimizer.zero_grad(set_to_none=True)
        (l_pi + l_v).backward()
        if self.mesh:
            # The global batch's mean gradient and losses.
            l_pi, l_v = M.all_reduce_mean_(self.model, l_pi, l_v)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return l_pi.detach(), l_v.detach()

    def current_lr(self, iteration: int) -> float:
        if self.args.get("scheduler", "multistep") == "multistep":
            sa = self.args.get("scheduler_args", Args())
            return multistep_lr(self.args.lr, sa.get("milestones", []),
                                sa.get("gamma", 1.0), iteration)
        return float(self.args.lr)

    def train(self, batches: Iterable, train_steps: int, iteration: int = 0,
              callback=None) -> Tuple[float, float]:
        """Step-capped loop over a batch iterable (NNetWrapper.py:123-205);
        returns the mean (policy, value) losses.

        The host never waits for the step it just enqueued: each step's
        losses are read back ``PIPE`` steps later. A re-iterable (a list)
        restarts when exhausted; a one-shot iterator ends the loop early,
        with a warning.
        """
        lr = self.current_lr(iteration)
        pi_sum = v_sum = 0.0
        count = step = 0
        pend: deque = deque()

        def drain_one():
            nonlocal pi_sum, v_sum, count
            s, a, b = pend.popleft()
            pi_sum += float(a)
            v_sum += float(b)
            count += 1
            if callback is not None:
                callback(s, train_steps, pi_sum / count, v_sum / count)

        self.model.train()
        try:
            while step < train_steps:
                it = iter(batches)
                one_shot = it is batches
                produced = False
                for batch in it:
                    l_pi, l_v = self._train_step(batch, lr)
                    produced = True
                    step += 1
                    pend.append((step, l_pi, l_v))
                    while len(pend) > PIPE:
                        drain_one()
                    if step >= train_steps:
                        break
                if step < train_steps and (one_shot or not produced):
                    print(f"Warning: batch source exhausted at step "
                          f"{step}/{train_steps}")
                    break
        finally:
            self.model.eval()
        while pend:
            drain_one()
        self.l_pi = pi_sum / max(count, 1)
        self.l_v = v_sum / max(count, 1)
        return self.l_pi, self.l_v

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, folder: str, filename: str) -> str:
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, filename)
        torch.save({"format": "alphazero_general_tpu_torch",
                    "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "step": self.step}, path + ".ckpt")
        save_args_file(self.args, path + ".json")
        return path + ".ckpt"

    def load_checkpoint(self, folder: str, filename: str) -> None:
        """Load weights, optimizer state and step in place (closures over
        ``self.model`` see the new weights), from the port's checkpoint or
        the JAX package's flax one."""
        path = os.path.join(folder, filename) + ".ckpt"
        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(_TORCH_MAGIC):
            self._load_torch(path)
        else:
            self._load_flax(path, data)
        if self.mesh:
            M.replicate_module(self.model)

    def _load_torch(self, path: str) -> None:
        try:
            payload = torch.load(path, map_location=self.device,
                                 weights_only=True)
        except (pickle.UnpicklingError, EOFError, RuntimeError) as e:
            raise ValueError(f"{path} is not a checkpoint of either "
                             f"package: {e}") from e
        if not isinstance(payload, dict) or payload.get("format") != \
                "alphazero_general_tpu_torch":
            raise ValueError(f"{path} is not a checkpoint of this package")
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])

    def _load_flax(self, path: str, data: bytes) -> None:
        """A ``NetState`` of the JAX package: params and batch statistics
        through utils/convert.py; the optax chain's ``trace`` (state 1 of
        ``add_decayed_weights``, ``trace``; wrapper.py:59-65 of the JAX
        package) as each parameter's SGD momentum buffer, which follows the
        same update; and ``step``."""
        try:
            tree = from_bytes(data)
        except ValueError as e:
            raise ValueError(f"{path} is not a checkpoint of either "
                             f"package: {e}") from e
        if not isinstance(tree, dict) or not {
                "params", "batch_stats", "opt_state", "step"} <= set(tree):
            raise ValueError(f"{path} is not a checkpoint of either package "
                             "(no flax NetState)")
        stats = tree["batch_stats"]
        try:
            state = state_dict_from_jax({"params": tree["params"],
                                         "batch_stats": stats})
            self.model.load_state_dict(state)
        except (KeyError, RuntimeError) as e:
            raise ValueError(f"{path}: the flax NetState does not fit this "
                             f"wrapper's model: {e}") from e
        self.optimizer.state.clear()
        trace = tree["opt_state"].get("1", {}).get("trace")
        if trace:
            buffers = state_dict_from_jax({"params": trace,
                                           "batch_stats": stats})
            for name, param in self.model.named_parameters():
                self.optimizer.state[param] = {
                    "momentum_buffer": buffers[name].to(self.device)}
        self.step = int(tree["step"])

    @classmethod
    def from_checkpoint(cls, env, folder: str, filename: str,
                        override_args: Args | None = None,
                        device="cuda") -> "NNetWrapper":
        """A wrapper rebuilt from a checkpoint and its saved args
        (NNetWrapper.py:252-282)."""
        args = load_args_file(os.path.join(folder, filename) + ".json")
        if override_args:
            args.update(override_args)
        wrapper = cls(env, get_args(args), device=device)
        wrapper.load_checkpoint(folder, filename)
        return wrapper
