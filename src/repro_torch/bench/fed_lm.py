"""Federated LM fine-tuning on the port, the one-device engine path of
``examples/fed_lm_finetune.py`` (its ``--mesh D`` branch at D = 1).

K clients hold disjoint Markov token streams (``data.synthetic_lm_tokens``,
one seed per client); each round a uniform cohort fine-tunes the dense
decoder for U local AdamW steps under deterministic E4M3 QAT, every
projection on the fused B10/B11 kernels, and the models cross the paper's
E4M3 stochastic wire both ways into a weighted mean, all through
``core.engine.RoundEngine``. The example's defaults: 8 clients, 4 active, 8
local steps at batch 4, sequence 64, AdamW(1e-3, weight decay 0.01). The
config is ``--arch`` (default TinyLlama-1.1B at full width) or, with
``--reduced``, its CPU-sized version, as ``repro/launch/train.py`` picks
it. Weights are random, drawn from ``--seed`` with torch. Runs on the card
unless ``--device cpu`` is given:

    python -m repro_torch.bench.fed_lm [--device cuda|cpu] [--arch A] [--reduced]
        [--rounds R] [--clients K] [--active P] [--local-steps U] [--seq T]
        [--no-qat] [--codec NAME] [--server-opt mean]

Each round prints the mean local loss, the wire bytes (on a static link
asserted equal to ``RoundEngine.round_bytes``), seconds per round and, on
the card, the peak device memory so far. Not ported: the example's
``--mesh``, ``--scale`` and ``--scaling`` options and the FedAvgM / FedAdam
server tails.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .. import configs, optim
from ..core.engine import FedConfig, RoundEngine
from ..core.qat import DISABLED, QATConfig
from ..data import synthetic_lm_tokens
from ..device import resolve_device
from ..kernels import fp8_quant
from ..models.registry import get_model
from ..tree import leaves

BATCH = 4             # the example's FedConfig(batch_size=4)
STREAM_TOKENS = 40_000


def downlink_codec(name: str) -> str:
    """The example's ``_downlink_codec``: strip the uplink-only wrappers (ef,
    delta) off a codec spec."""
    if name == "ef":
        return "e4m3"
    if name.startswith("ef:"):
        name = name[len("ef:"):]
    parts = [p for p in name.split(":") if p != "delta"]
    return ":".join(parts) or "e4m3"


def codec_kw(codec: str | None) -> dict:
    """FedConfig codec fields for ``--codec``, as the example builds them."""
    if not codec:
        return {}
    kw = {"up_codec": codec}
    down = downlink_codec(codec)
    if down != "e4m3" or not (codec.startswith("delta") or codec.startswith("ef")):
        kw["down_codec"] = down
    return kw


def client_data(n_clients: int, local_steps: int, seq: int, vocab: int):
    """``(K, U * B, T)`` int64 tokens and next-token labels: client ``c``'s
    stream is ``synthetic_lm_tokens(c, ...)``, cut into ``U * B`` windows of
    ``T + 1`` tokens as the example's ``client_batches_for`` cuts it."""
    xs, ys = [], []
    for c in range(n_clients):
        s = synthetic_lm_tokens(c, STREAM_TOKENS, vocab)
        w = s[: local_steps * BATCH * (seq + 1)].reshape(local_steps * BATCH, seq + 1)
        xs.append(w[:, :-1])
        ys.append(w[:, 1:])
    as_t = lambda a: torch.from_numpy(np.stack(a).astype(np.int64))
    return as_t(xs), as_t(ys)


def run(*, arch: str = "tinyllama_1_1b", reduced: bool = False, rounds: int = 8,
        clients: int = 8, active: int = 4, local_steps: int = 8, seq: int = 64,
        no_qat: bool = False, codec: str | None = None, server_opt: str = "mean",
        seed: int = 0, device="cuda", wrap_round=None, log=print) -> list[dict]:
    """Rows of the run, one a round. ``wrap_round(r)`` may return a context
    manager around round ``r`` (a profiler). On the card each row carries
    the peak device memory since the start of the run and the launches of
    each kernel in the round."""
    if server_opt != "mean":
        raise NotImplementedError(f"--server-opt {server_opt}: only 'mean' is ported "
                                  "(FedAvgM / FedAdam: ROADMAP §1 item 4)")
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    model = get_model(cfg)
    qcfg = DISABLED if no_qat else QATConfig()
    fed = FedConfig(n_clients=clients, participation=active / clients,
                    local_steps=local_steps, batch_size=BATCH,
                    comm_mode="none" if no_qat else "rand", qat=qcfg, **codec_kw(codec))

    def loss_fn(params, xb, yb, qat_cfg):
        return model.train_loss(params, {"tokens": xb, "labels": yb}, qat_cfg)

    t0 = time.perf_counter()
    cdata, clabels = client_data(clients, local_steps, seq, cfg.vocab)
    cdata, clabels = cdata.to(dev), clabels.to(dev)
    nk = torch.ones(clients, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = model.init(seed, device=dev)
    eng = RoundEngine(loss_fn, optim.adamw(1e-3, weight_decay=0.01), fed, device=dev)
    state = eng.init(params)
    del params
    static = eng.round_bytes(state.params)
    n_params = sum(t.numel() for t in leaves(state.params))
    log(f"[fed_lm] {cfg.name}{' (reduced)' if reduced else ''}: {n_params} parameters, "
        f"K={clients} P={eng.cohort} U={local_steps} B={BATCH} T={seq}, "
        f"{eng.link.down_c.tag} down / {eng.link.up_c.tag} up, "
        f"{static} wire bytes a round, on {dev}; data and init "
        f"{time.perf_counter() - t0:.2f} s")
    g = torch.Generator().manual_seed(seed + 1)
    rows = []
    for r in range(rounds):
        draws = eng.draw(g, nk.cpu(), cdata.shape[1])
        before = dict(fp8_quant.LAUNCHES)
        ctx = wrap_round(r) if wrap_round is not None else contextlib.nullcontext()
        with ctx:
            _sync(dev)
            t0 = time.perf_counter()
            state, m = eng.round_fn(state, cdata, clabels, nk, draws)
            loss = float(m["local_loss"])
            wire = int(m["wire_bytes"])
            _sync(dev)
            dt = time.perf_counter() - t0
        if eng.dynamic:
            assert 0 < wire <= static, (wire, static)
        else:
            assert wire == static, (wire, static)
        row = {"round": r + 1, "local_loss": loss, "wire_bytes": wire,
               "s_per_round": dt,
               "launches": {k: v - before[k] for k, v in fp8_quant.LAUNCHES.items()}}
        line = (f"round {r + 1}: mean local loss {loss:.4f}  wire {wire} B "
                f"(bound {static})  {dt:.3f} s/round")
        if dev.type == "cuda":
            row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            line += f"  peak memory {row['peak_mem_bytes'] / 2 ** 30:.2f} GiB"
        log(line)
        rows.append(row)
    return rows


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--active", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--codec", default=None,
                    help="wire codec registry name (e4m3, fp4, delta:e4m3, "
                         "rans:delta:e4m3, ef:fp4_e2m1_det, ...); default the "
                         "paper's E4M3 wire. Uplink-only wrappers (delta, ef) stay "
                         "on the uplink")
    ap.add_argument("--server-opt", default="mean", choices=["mean"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(arch=args.arch, reduced=args.reduced, rounds=args.rounds, clients=args.clients,
        active=args.active, local_steps=args.local_steps, seq=args.seq,
        no_qat=args.no_qat, codec=args.codec, server_opt=args.server_opt,
        seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
