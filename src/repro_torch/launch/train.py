"""Training driver of the port, the counterpart of ``repro.launch.train``.

Examples:
  python -m repro_torch.launch.train --arch granite-3-2b --steps 4 --batch 4 --seq 1024
  python -m repro_torch.launch.train --arch h2o-danube-1.8b --smoke --steps 30 --device cpu
  python -m repro_torch.launch.train --arch xdeepfm --smoke --device cpu
  python -m repro_torch.launch.train --arch gcn-cora --smoke --device cpu

Runs on ``--device`` (default ``cuda``: the models' K4, K5 and K6 and their
backward kernels; ``--device cpu`` runs their plain versions).  A step is a
Python function: the loss, ``torch.autograd.grad`` over every parameter,
the warmup + cosine learning rate and AdamW (``repro_torch.optim``), the
JAX package's hyperparameters.  Fault tolerance: ``--ckpt-dir`` with
``--ckpt-every`` enables checkpoint/restart, and re-running the same
command resumes from the latest step; ``--fail-at N`` injects a crash
before step N, after which the run restores the latest checkpoint and
carries on.  GraphCast trains nowhere here, as in the JAX package: its
driver is the dry run.
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import torch

from repro_torch.configs import get_arch
from repro_torch.data.synth import graph_batch_from_csr, lm_batch, recsys_batch
from repro_torch.device import resolve_device
from repro_torch.ft import FaultTolerantLoop, SimulatedFailure
from repro_torch.graph.generators import random_dag
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import tree_leaves


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _lm_setup(mod, args, dev):
    from repro_torch.models import transformer as tf

    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    params = tf.init_params(cfg, _generator(args.seed, dev), device=dev)
    batch_fn = lambda s: lm_batch(args.seed, s, args.batch, args.seq, cfg.vocab,  # noqa: E731
                                  device=dev)
    return cfg, params, partial(tf.lm_loss, cfg), batch_fn, 0.1


def _recsys_setup(mod, args, dev):
    from repro_torch.models.recsys import xdeepfm

    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    params = xdeepfm.init_params(cfg, _generator(args.seed, dev), device=dev)
    batch_fn = lambda s: recsys_batch(args.seed, s, args.batch, cfg.n_fields,  # noqa: E731
                                      cfg.vocab_per_field, device=dev)
    return cfg, params, partial(xdeepfm.loss_fn, cfg), batch_fn, 1e-5


def _gnn_setup(mod, args, dev):
    arch = mod.ARCH_ID
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    g = random_dag(args.gnn_nodes, args.gnn_nodes * 3, seed=args.seed)
    if arch == "gcn-cora":
        from repro_torch.models.gnn import gcn as model
        batch = graph_batch_from_csr(g, cfg.d_in, seed=args.seed, n_classes=cfg.n_classes,
                                     device=dev)
        loss_fn = partial(model.loss_fn, cfg, ell=model.graph_ell(batch))
    elif arch == "gatedgcn":
        from repro_torch.models.gnn import gatedgcn as model
        batch = graph_batch_from_csr(g, cfg.d_in, seed=args.seed, n_classes=cfg.n_classes,
                                     d_edge=cfg.d_edge_in, device=dev)
        loss_fn = partial(model.loss_fn, cfg)
    elif arch == "schnet":
        from repro_torch.models.gnn import schnet as model
        batch = graph_batch_from_csr(g, 1, seed=args.seed, with_pos=True, device=dev)
        batch = batch._replace(y=torch.tensor(3.0, device=dev))
        loss_fn = partial(model.loss_fn, cfg)
    else:
        raise SystemExit(f"use dryrun for {arch}")
    params = model.init_params(cfg, _generator(args.seed, dev), device=dev)
    return cfg, params, lambda p, _: loss_fn(p, batch), lambda s: None, 0.1


SETUPS = {"lm": _lm_setup, "recsys": _recsys_setup, "gnn": _gnn_setup}


def setup(args):
    """(cfg, params, loss_of(params, batch), batch_fn(step), weight decay) of
    ``args.arch`` on ``args.device``."""
    mod = get_arch(args.arch)
    if mod.FAMILY not in SETUPS:
        raise SystemExit(f"train driver does not cover family {mod.FAMILY}")
    return SETUPS[mod.FAMILY](mod, args, resolve_device(args.device))


def make_step(loss_of, args, weight_decay: float):
    """One training step: (state, batch) -> (state, metrics); the params and
    the optimizer state are updated in place (``adamw_update``)."""

    def step(state, batch):
        params, opt = state
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_of(params, batch)
        # a leaf the loss does not reach (gatedgcn's last edge update) gets 0, as jax.grad's
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        lr = cosine_schedule(opt.step, args.lr, warmup=20, total=args.steps)
        params, opt, metrics = adamw_update(grads, opt, params, lr, weight_decay=weight_decay)
        metrics["loss"] = loss.detach()
        return (params, opt), metrics

    return step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gnn-nodes", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Train; returns the metrics of the steps logged (every step without
    ``--ckpt-dir``: loss, grad_norm, lr, step and its seconds)."""
    args = parse_args(argv)

    def start(fail_at):
        _, params, loss_of, batch_fn, wd = setup(args)
        return FaultTolerantLoop(make_step(loss_of, args, wd), batch_fn,
                                 (params, adamw_init(params)), args.ckpt_dir,
                                 ckpt_every=args.ckpt_every, fail_at=fail_at)

    if args.ckpt_dir:
        loop = start(args.fail_at)
        try:
            loop.run(args.steps, log_every=1)
        except SimulatedFailure as e:
            # restart as a new process would: fresh state from the seed, then the
            # latest complete checkpoint (the save in flight at the crash may be lost)
            print(f"!! {e} -- restarting from checkpoint", flush=True)
            failed, loop = loop, start(None)
            loop.metrics_log = failed.metrics_log
            loop.run(args.steps, log_every=1)
        for m in loop.metrics_log:
            print(m, flush=True)
        return loop.metrics_log

    _, params, loss_of, batch_fn, wd = setup(args)
    state, step = (params, adamw_init(params)), make_step(loss_of, args, wd)

    log = []
    for s in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch_fn(s))
        m = {k: float(v) for k, v in metrics.items()}   # float() waits for the step
        m.update(step=s, sec=time.perf_counter() - t0)
        log.append(m)
        if s % 10 == 0 or s == args.steps - 1:
            print(m, flush=True)
    return log


if __name__ == "__main__":
    main()
