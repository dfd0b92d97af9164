"""Shared benchmark plumbing: the task registry and the paper's federated
method grid, the port of ``benchmarks/common.py``.

Tasks are synthetic matched-dimension stand-ins for the paper's datasets
(numpy generators of ``repro_torch.data``, draw for draw those of the
reference); models are initialised from ``seed`` with torch, so their
random weights are not the reference's. Every task of the reference is
here: the paper's CIFAR10/100 with LeNet or ResNet (and the MLP), and
SpeechCommands with MatchboxNet or KWT.
"""
from __future__ import annotations

import dataclasses

from .. import optim
from ..core.engine import FedConfig
from ..core.fedsim import FedHistory, FedSim
from ..core.qat import DISABLED, QATConfig, clip_value_mask, weight_decay_mask
from ..core.server_opt import ServerOptConfig
from ..data import (
    partition_dirichlet,
    partition_iid,
    synthetic_classification,
    synthetic_images,
    synthetic_sequences,
)
from ..models import small


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    model: str            # key into models.small.REGISTRY
    data_kind: str        # vector | image | sequence
    n_classes: int
    optimizer: str        # sgd | adamw
    lr: float


TASKS = {
    # lr 0.05 (paper: 0.1), as the reference: full W+A QAT at 0.1 sits past
    # the stability edge on the synthetic mini-setup
    "cifar10-lenet": Task("cifar10-lenet", "lenet", "image", 10, "sgd", 0.05),
    "cifar10-resnet": Task("cifar10-resnet", "resnet", "image", 10, "sgd", 0.05),
    "cifar100-lenet": Task("cifar100-lenet", "lenet", "image", 100, "sgd", 0.05),
    "cifar100-mlp": Task("cifar100-mlp", "mlp", "vector", 100, "sgd", 0.05),
    "speech-matchbox": Task("speech-matchbox", "matchbox", "sequence", 35, "adamw", 1e-3),
    "speech-kwt": Task("speech-kwt", "kwt", "sequence", 35, "adamw", 1e-3),
}

METHODS = ("fp32", "uq", "uq+", "det-cq", "qat-only", "rand-qat", "rand-qat-only")


def make_data(task: Task, n_train: int, n_test: int, seed: int = 0):
    n = n_train + n_test
    if task.data_kind == "image":
        x, y = synthetic_images(seed, n, n_classes=task.n_classes, noise=0.45)
    elif task.data_kind == "sequence":
        x, y = synthetic_sequences(seed, n, n_classes=task.n_classes, noise=0.9)
    else:
        x, y = synthetic_classification(seed, n, d=64, n_classes=task.n_classes,
                                        noise=1.6)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def make_model(task: Task, seed: int, device):
    init, apply = small.REGISTRY[task.model]
    if task.data_kind == "vector":
        params = init(seed, d_in=64, n_classes=task.n_classes, device=device)
    else:
        params = init(seed, n_classes=task.n_classes, device=device)
    return params, apply


def make_optimizer(task: Task, params: dict) -> optim.Optimizer:
    """The task's client optimizer, decay on the weights, the clip values in
    the trust region."""
    wdm, tm = weight_decay_mask(params), clip_value_mask(params)
    if task.optimizer == "adamw":
        return optim.adamw(task.lr, weight_decay=0.1, wd_mask=wdm, trust_mask=tm)
    return optim.sgd(task.lr, weight_decay=1e-3, wd_mask=wdm, trust_mask=tm)


def method_cfg(method: str, n_clients: int, participation: float,
               local_steps: int, batch: int) -> FedConfig:
    """Paper's method grid: fp32 | uq | uq+ | det-cq (biased) | qat-only |
    rand-qat | rand-qat-only (the last four are Table 2's ablations)."""
    base = dict(n_clients=n_clients, participation=participation,
                local_steps=local_steps, batch_size=batch)
    if method == "fp32":
        return FedConfig(comm_mode="none", qat=DISABLED, **base)
    if method == "uq":
        return FedConfig(comm_mode="rand", qat=QATConfig(), **base)
    if method == "uq+":
        return FedConfig(comm_mode="rand", qat=QATConfig(),
                         server_opt=ServerOptConfig(enabled=True, gd_steps=5,
                                                    lr=0.1, n_grid=20), **base)
    if method == "det-cq":   # biased communication ablation (Table 2)
        return FedConfig(comm_mode="det", qat=QATConfig(), **base)
    if method == "rand-qat":  # stochastic QAT ablation (Table 2)
        return FedConfig(comm_mode="rand", qat=QATConfig(mode="rand"), **base)
    if method == "qat-only":  # FP8 QAT without communication quantization
        return FedConfig(comm_mode="none", qat=QATConfig(), **base)
    if method == "rand-qat-only":
        return FedConfig(comm_mode="none", qat=QATConfig(mode="rand"), **base)
    raise ValueError(f"method {method!r}: one of {METHODS}")


def run_method(task: Task, method: str, *, rounds: int, k: int, c: float,
               local_steps: int, batch: int, n_train: int, n_test: int,
               noniid: bool, seed: int = 0, eval_every: int = 5,
               device="cuda") -> tuple[FedHistory, int]:
    """One federated run of ``method`` on ``task``: ``(history, bytes/round)``."""
    (x, y), (xt, yt) = make_data(task, n_train, n_test, seed)
    if noniid:
        cx, cy, nk = partition_dirichlet(x, y, k=k, concentration=0.3, seed=seed)
    else:
        cx, cy, nk = partition_iid(x, y, k=k, seed=seed)
    params, apply = make_model(task, seed, device)
    cfg = method_cfg(method, k, c, local_steps, batch)
    sim = FedSim(params, small.make_loss(apply), apply, make_optimizer(task, params),
                 cfg, cx, cy, nk, device=device)
    hist = sim.run(rounds, seed=seed + 99, eval_data=(xt, yt), eval_every=eval_every)
    return hist, sim.bytes_per_round


def comm_gain(hist_fp32: FedHistory, bytes_fp32: int, hist_fp8: FedHistory,
              bytes_fp8: int) -> float:
    """Paper Table 1: gain at the max accuracy reached by BOTH methods."""
    target = min(hist_fp32.best_accuracy(), hist_fp8.best_accuracy())
    b32 = hist_fp32.bytes_to_accuracy(target)
    b8 = hist_fp8.bytes_to_accuracy(target)
    if b32 is None or b8 is None:
        return float("nan")
    return b32 / b8
