"""Train a small LM end to end on the port, with checkpoint/restart fault
tolerance: the counterpart of ``examples/train_lm.py``.

Default: a ~10M-parameter danube-family model (a sliding window as long as
the sequence), 120 steps, float32.  ``--device cpu`` runs K4's plain version
and its plain backward; on the card (the default) K4 and its backward
kernel.  The production config is ``--arch h2o-danube-1.8b`` without
``--smoke`` through ``repro_torch.launch.train``.

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --fail-at 40   # crash + restart
"""
import argparse
import os
import tempfile

import torch

from repro_torch.data.synth import lm_batch
from repro_torch.ft import FaultTolerantLoop, SimulatedFailure
from repro_torch.launch.train import make_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = tf.LMConfig(
        name="example-lm",
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=max(args.d_model // 64, 2),
        n_kv_heads=max(args.d_model // 128, 1),
        d_ff=args.d_model * 3,
        vocab=args.vocab,
        window=args.seq,
        dtype=torch.float32,
        remat=False,
    )
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    def loop(fail_at):
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = tf.init_params(cfg, gen, device=args.device)
        return FaultTolerantLoop(
            step_fn=make_step(lambda p, b: tf.lm_loss(cfg, p, b), args, 0.1),
            batch_fn=lambda s: lm_batch(0, s, args.batch, args.seq, cfg.vocab,
                                        device=args.device),
            init_state=(params, adamw_init(params)),
            ckpt_dir=args.ckpt_dir,
            ckpt_every=20,
            fail_at=fail_at,
        )

    run = loop(args.fail_at)
    try:
        run.run(args.steps)
    except SimulatedFailure as e:
        # restart as a new process would: fresh weights, then the latest checkpoint
        print(f"!! {e} -- restarting from the latest checkpoint")
        failed, run = run, loop(None)
        run.metrics_log = failed.metrics_log
        run.run(args.steps)
    for m in run.metrics_log:
        print({k: round(v, 4) if isinstance(v, float) else v for k, v in m.items()})
    first, last = run.metrics_log[0]["loss"], run.metrics_log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
