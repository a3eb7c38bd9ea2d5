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
so the port, which compiles nothing, does not pad on one device.

``mesh`` (a ``parallel.mesh.Mesh``) trains data parallel over its data
rows, with the heads cut over its model axis (JAX train_lib.py:52-59,
138-140, 166-190), from one process:

- replica i of the model lives on ``mesh.devices[i, 0]``; replica 0, the
  primary, holds the parameters and the Adam state (``model``,
  ``device``), and the others get a copy of its parameters at the start
  of every step;
- each group's k rows are padded with zero-weight rows as JAX pads them,
  to max(next power of two of k, the mesh's device count), and split into
  contiguous shares over the data rows; each replica computes the weighted
  L1 sum of its share and its backward (inside ``activation_sharding``
  when the model axis is above 1: the heads run on the plain attention,
  group by group on the row's devices);
- the gradients are summed onto the primary in replica order and divided
  by the batch size; Adam steps on the primary; checkpoints are saved from
  it; ``fit``'s ``device_cache`` is off, as in JAX.

Each replica draws its own dropout masks, so a mesh step equals the
single-device step only at dropout 0 (and then within f32 summation
order).
"""

from __future__ import annotations

import contextlib
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
from transformerupscaler_torch.ops.resize import resize_antialias_bilinear
from transformerupscaler_torch.parallel.context import activation_sharding
from transformerupscaler_torch.parallel.mesh import Mesh
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import (
    flatten,
    init_params,
    jax_path,
    params_from_jax,
    params_to_jax,
    unflatten,
)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class Trainer:
    """JAX ``Trainer``'s arguments, plus ``device`` (default: the card;
    under a ``mesh``, its first device)."""

    def __init__(self, model_name: str, checkpoint_dir: str | None = None,
                 learning_rate: float = 1e-4, dtype=torch.bfloat16,
                 attn_impl: str = "xla", mesh=None, root: str = ".",
                 device=None, **model_kw):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            devices = list(mesh.devices[:, 0])
            if device is not None and torch.device(device) != devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {devices[0]}")
        self.device = devices[0]
        self.model_name = model_name
        self.replicas = [get_model(model_name, device=d, dtype=dtype,
                                   attn_impl=attn_impl, **model_kw)
                         for d in devices]
        self.model = self.replicas[0]
        self.names = {jax_path(n): p
                      for n, p in self.model.named_parameters()}
        if not self.names:
            raise ValueError(f"{model_name} has no parameters to train")
        for model in self.replicas:
            model.requires_grad_(True)
            model.train()
        self.checkpoint_dir = checkpoint_dir or default_checkpoint_dir(
            model_name, root)
        self.learning_rate = learning_rate
        self.optimizer = None  # made with the parameters
        self.epochs_trained = 0
        # uint8 / 255 as a true f32 division (module docstring), by the
        # device each replica's parameters are on.
        self._255 = {}
        for model in self.replicas:
            dev = next(model.parameters()).device
            self._255[dev] = torch.full((), 255.0, device=dev)

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
    def _on_device(self, a, device) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        a = a.to(device)
        return a.float() / self._255[device] if a.dtype == torch.uint8 else a

    def bucket_loss_sum(self, lrs, hrs, generator=None, model=None,
                        weights=None) -> torch.Tensor:
        """The sum over one geometry's samples of each sample's L1 loss
        (float32, a 0-d tensor under autograd), each weighted by
        ``weights`` if given; ``model``: a replica (default the primary),
        on whose device the samples are put."""
        model = self.model if model is None else model
        dev = next(model.parameters()).device
        lrs, hrs = self._on_device(lrs, dev), self._on_device(hrs, dev)
        out = model(lrs, res_out=tuple(hrs.shape[1:3]), require_ratio=False,
                    generator=generator)
        if out.shape[1:3] != hrs.shape[1:3]:
            out = resize_antialias_bilinear(out, tuple(hrs.shape[1:3]))
        per_sample = (out.float() - hrs.float()).abs().mean(dim=(1, 2, 3))
        if weights is not None:
            per_sample = per_sample * weights.to(dev)
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
        if self.mesh is None:
            total = torch.zeros((), device=self.device)
            for lrs, hrs in bucket_batch(samples).values():
                loss_sum = self.bucket_loss_sum(lrs, hrs, generator)
                loss_sum.backward()
                total += loss_sum.detach()
        else:
            total = self._mesh_grads(samples, generator)
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

    def _mesh_grads(self, samples, generator) -> torch.Tensor:
        """The mesh step's loss sum over the batch, with the gradients
        summed into the primary's ``.grad`` (module docstring)."""
        with torch.no_grad():
            for model in self.replicas[1:]:
                for p, src in zip(model.parameters(),
                                  self.model.parameters()):
                    p.copy_(src)
                    p.grad = None
                if hasattr(model, "clear_derived"):
                    model.clear_derived()
        n_dev = self.mesh.devices.size
        tp = self.mesh.shape["model"] > 1
        total = torch.zeros((), device=self.device)
        for lrs, hrs in bucket_batch(samples).values():
            k = lrs.shape[0]
            rows = max(_next_pow2(k), n_dev)
            lrs, hrs = _pad_rows(lrs, rows), _pad_rows(hrs, rows)
            weights = torch.zeros(rows)
            weights[:k] = 1.0
            per = -(-rows // len(self.replicas))
            for i, model in enumerate(self.replicas):
                share = slice(i * per, (i + 1) * per)
                ctx = (activation_sharding(self.mesh, row=i) if tp
                       else contextlib.nullcontext())
                with ctx:
                    loss_sum = self.bucket_loss_sum(
                        lrs[share], hrs[share], generator, model,
                        weights[share])
                    loss_sum.backward()
                total += loss_sum.detach().to(self.device)
        with torch.no_grad():
            for model in self.replicas[1:]:
                for p, src in zip(self.model.parameters(),
                                  model.parameters()):
                    if src.grad is None:
                        continue
                    g = src.grad.to(p.device)
                    if p.grad is None:
                        p.grad = g.clone()
                    else:
                        p.grad += g
        return total

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
        if device_cache and self.mesh is None:
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


def _pad_rows(a, rows: int):
    """A bucket's stacked samples (numpy or tensor) with zero rows added up
    to ``rows``."""
    pad = rows - a.shape[0]
    if not pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])


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
