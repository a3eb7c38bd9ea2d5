"""Training: L1 objective, Adam, auto-resume, geometry-bucketed batches
(JAX counterpart: transformerupscaler_tpu/train_lib.py).

As in the JAX package (and the reference train.py:103-156):

- the loss of a batch is the mean over its samples of each sample's mean
  absolute error, computed in float32; one Adam step per batch (lr 1e-4,
  betas 0.9 / 0.999, eps 1e-8: ``torch.optim.Adam``, optax ``adam``'s
  update);
- a batch mixes geometries: its samples are grouped by (LR, HR) shape
  (``data.bucketing.bucket_batch``), each group runs one batched forward
  and backward, the gradients are summed over the groups and divided by
  the batch size;
- an output whose size is not the HR target's (``require_ratio=False``) is
  squashed to it by the antialiased bilinear resize (train.py:127-130);
- uint8 batches are normalized on the device, as float32(x) / 255 divided
  by a device tensor (a true division, as JAX's; a CUDA tensor divided by
  a Python scalar is multiplied by its reciprocal);
- ``fit`` resumes from the latest ``model_epoch_{n}`` of ``checkpoint_dir``
  (parameters and, where the checkpoint has one, the Adam state; fresh
  moments otherwise, as for the committed weights' numpy copies), exits
  with code 3 when that checkpoint already reaches ``epochs``, and writes
  ``model_epoch_{n}.npz`` every ``checkpoint_interval`` epochs.

The models train in train mode (JAX's ``deterministic=False``): the plain
PyTorch path under autograd with dropout; the port's CUDA kernels have no
backward, as the Pallas kernels have no VJP, so training launches none.
Parameters and Adam moments are float32; compute runs in ``dtype`` (bf16
by default, as in JAX; no loss scaling). JAX pads each group's rows to a
power of two to bound its jit cache; the padded rows weigh 0 in the loss,
so the port, which compiles nothing, does not pad. ``mesh`` (data and
tensor parallelism over several chips) is not ported yet (ROADMAP.md
section 1 item 9).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from transformerupscaler_torch.checkpoint import (
    default_checkpoint_dir,
    get_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from transformerupscaler_torch.data.bucketing import (
    batched,
    bucket_batch,
    prefetched,
)
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.ops.resize import resize
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import (
    flatten,
    init_params,
    jax_path,
    params_from_jax,
    params_to_jax,
    unflatten,
)


class Trainer:
    """JAX ``Trainer``'s arguments, plus ``device`` (default: the card)."""

    def __init__(self, model_name: str, checkpoint_dir: str | None = None,
                 learning_rate: float = 1e-4, dtype=torch.bfloat16,
                 attn_impl: str = "xla", mesh=None, root: str = ".",
                 device=None, **model_kw):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): multi-GPU training is not ported yet "
                "(ROADMAP.md section 1 item 9)")
        self.device = resolve_device(device)
        self.model_name = model_name
        self.model = get_model(model_name, device=self.device, dtype=dtype,
                               attn_impl=attn_impl, **model_kw)
        self.names = {jax_path(n): p
                      for n, p in self.model.named_parameters()}
        if not self.names:
            raise ValueError(f"{model_name} has no parameters to train")
        self.model.requires_grad_(True)
        self.model.train()
        self.checkpoint_dir = checkpoint_dir or default_checkpoint_dir(
            model_name, root)
        self.learning_rate = learning_rate
        self.optimizer = None  # made with the parameters
        self.epochs_trained = 0
        # uint8 / 255 as a true f32 division (module docstring).
        self._255 = torch.full((), 255.0, device=self.device)

    # ------------------------------------------------------------------
    def _new_optimizer(self) -> None:
        self.optimizer = torch.optim.Adam(
            self.names.values(), lr=self.learning_rate, betas=(0.9, 0.999),
            eps=1e-8)

    def init_params(self, sample_lr_hw=None, sample_hr_hw=None,
                    rng_seed: int = 0) -> None:
        """Fresh parameters as the JAX models initialise them
        (``weights.init_params``) and fresh Adam moments. The sample
        geometry JAX traces ``init`` with does not shape any parameter."""
        del sample_lr_hw, sample_hr_hw
        params_from_jax(self.model, init_params(self.model, rng_seed,
                                                self.device))
        self._new_optimizer()

    def params(self) -> dict:
        """The parameters as a JAX tree of float32 numpy arrays."""
        return params_to_jax(self.model)

    def opt_state(self) -> dict | None:
        """The Adam state {"mu": tree, "nu": tree, "count": int} (float32
        numpy copies, JAX paths), as optax's ``ScaleByAdamState`` holds it;
        None before the first step."""
        if self.optimizer is None:
            return None
        states = [self.optimizer.state.get(p) for p in self.names.values()]
        if not all(states):
            return None
        mu, nu = {}, {}
        for path, state in zip(self.names, states):
            mu[path] = np.array(state["exp_avg"].detach().cpu())
            nu[path] = np.array(state["exp_avg_sq"].detach().cpu())
        return {"mu": unflatten(mu), "nu": unflatten(nu),
                "count": int(states[0]["step"])}

    def set_opt_state(self, opt_state: dict | None) -> None:
        """Fresh Adam moments, or those of ``opt_state`` (as ``opt_state``
        returns it, or ``weights.opt_state_from_jax`` converts it)."""
        self._new_optimizer()
        if opt_state is None:
            return
        mu, nu = flatten(opt_state["mu"]), flatten(opt_state["nu"])
        if set(mu) != set(self.names) or set(nu) != set(self.names):
            raise ValueError("the Adam state's leaves are not the model's")
        for path, p in self.names.items():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(opt_state["count"])),
                "exp_avg": _moment(mu[path], p),
                "exp_avg_sq": _moment(nu[path], p)}

    def try_resume(self, epochs: int) -> bool:
        """Load the latest checkpoint; True if training should go on. As
        the reference (train.py:87-97) it refuses to go on when the
        checkpoint already reaches ``epochs``."""
        try:
            path, self.epochs_trained = get_latest_checkpoint(
                self.checkpoint_dir)
        except FileNotFoundError as e:
            print(f"Failed to load checkpoint: {e}")
            self.epochs_trained = 0
            return True
        print(f"Loading checkpoint: {path}")
        restored = load_checkpoint(path, self.model_name)
        params_from_jax(self.model, restored["params"])
        self.set_opt_state(restored["opt_state"])
        if self.epochs_trained >= epochs:
            print(f"Checkpoint {path} exceeds epochs {epochs}")
            return False
        return True

    # ------------------------------------------------------------------
    def _on_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        a = a.to(self.device)
        return a.float() / self._255 if a.dtype == torch.uint8 else a

    def bucket_loss_sum(self, lrs, hrs, generator=None) -> torch.Tensor:
        """The sum over one geometry's samples of each sample's L1 loss
        (float32, a 0-d tensor under autograd)."""
        lrs, hrs = self._on_device(lrs), self._on_device(hrs)
        out = self.model(lrs, res_out=tuple(hrs.shape[1:3]),
                         require_ratio=False, generator=generator)
        if out.shape[1:3] != hrs.shape[1:3]:
            out = resize(out, tuple(hrs.shape[1:3]), "bilinear",
                         antialias=True)
        per_sample = (out.float() - hrs.float()).abs().mean(dim=(1, 2, 3))
        return per_sample.sum()

    def train_step(self, samples, generator=None) -> float:
        """One Adam step over a list of (lr, hr) samples (HWC numpy arrays
        or tensors, float in [0, 1] or uint8); returns the batch loss, the
        mean of the per-sample L1 losses. ``generator`` draws the dropout
        masks (needed in train mode at a dropout above 0)."""
        if self.optimizer is None:
            self.init_params()
        n = len(samples)
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.device)
        for lrs, hrs in bucket_batch(samples).values():
            loss_sum = self.bucket_loss_sum(lrs, hrs, generator)
            loss_sum.backward()
            total += loss_sum.detach()
        for p in self.names.values():
            # A parameter the batch does not reach (another scale's
            # upsampler stage) gets a zero gradient, as under JAX's grad,
            # so that Adam decays its moments and counts the step.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.div_(n)
        self.optimizer.step()
        if hasattr(self.model, "clear_derived"):
            # What was derived from the parameters (the stacked trunk, the
            # composed tails) is stale now.
            self.model.clear_derived()
        return float(total) / n

    # ------------------------------------------------------------------
    def fit(self, dataset, epochs: int, batch_size: int = 6,
            log_interval: int = 1, checkpoint_interval: int = 1,
            seed: int = 0, resume: bool = True, steps_per_epoch=None,
            device_cache: bool = False) -> list[float]:
        """JAX ``fit``: train from ``epochs_trained`` to ``epochs``;
        returns each epoch's mean batch loss. ``device_cache`` keeps every
        sample tensor of 16 MB or less on the device as first given;
        dropout draws from one generator seeded with ``seed``."""
        if resume and not self.try_resume(epochs):
            # A distinct code: a supervisor must not take a crash (exit 1)
            # for "training complete".
            sys.exit(3)
        if device_cache:
            dataset = _DeviceCachedDataset(dataset, self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        epoch_losses = []
        for epoch in range(self.epochs_trained, epochs):
            running = 0.0
            n_batches = 0
            t0 = time.time()
            for batch_idx, batch in enumerate(prefetched(
                    batched(dataset, batch_size, shuffle=True,
                            seed=seed + epoch))):
                loss = self.train_step(batch, generator)
                running += loss
                n_batches += 1
                if batch_idx % log_interval == 0:
                    print(f"Epoch [{epoch + 1}/{epochs}] Step "
                          f"[{batch_idx + 1}] Loss: {loss:.6f}")
                if steps_per_epoch and n_batches >= steps_per_epoch:
                    break
            avg = running / max(n_batches, 1)
            epoch_losses.append(avg)
            print(f"Epoch [{epoch + 1}/{epochs}] completed. Average Loss: "
                  f"{avg:.6f} ({time.time() - t0:.1f}s)")
            if (epoch + 1) % checkpoint_interval == 0:
                path = save_checkpoint(self.checkpoint_dir, epoch + 1,
                                       self.params(), self.opt_state())
                print(f"Saved checkpoint: {path}")
        print("Training complete!")
        return epoch_losses


def _moment(v, p: torch.Tensor) -> torch.Tensor:
    """An Adam moment (numpy or tensor) as a float32 tensor beside ``p``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, np.float32))
    return v.to(p.device, torch.float32).reshape(p.shape).clone()


class _DeviceCachedDataset:
    """Samples moved to the device at first use and kept there, as given
    (uint8 stays uint8: the step normalizes on the device). Arrays above
    ``max_cache_bytes`` (4K targets) stay on the host, as in JAX."""

    def __init__(self, dataset, device, max_cache_bytes: int = 16 << 20):
        self._ds = dataset
        self._device = device
        self._max = max_cache_bytes
        self._cache: dict = {}

    def __len__(self):
        return len(self._ds)

    def _put(self, a):
        if a.nbytes > self._max:
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def __getitem__(self, i: int):
        if i not in self._cache:
            lr, hr = self._ds[i]
            self._cache[i] = (self._put(lr), self._put(hr))
        return self._cache[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
