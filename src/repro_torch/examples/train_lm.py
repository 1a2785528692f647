"""End-to-end training driver on the port: a ~100M-parameter LM for a few
hundred steps with checkpoint/restart, the counterpart of
``examples/train_lm.py``, through the port's ``Trainer``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200

Resume: rerun the same command — it restores the latest checkpoint. It
trains on the card unless given ``--device cpu`` (``--tiny`` for a
reduced model that the CPU runs in seconds).

``--cluster-sim`` (the sharded step on a simulated cluster with a host
death and an elastic restore) needs the scale-out runtime (ROADMAP step
10), which the port does not have yet: the flag raises
``NotImplementedError``, as ``serve_lm --cluster-sim`` does.
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import Trainer, TrainerConfig

# ~100M params: 12L x d=640 x ffn 2560, 10 heads, 32k vocab
LM100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=640, n_heads=10,
    n_kv_heads=10, d_head=64, d_ff=2560, vocab=32768, tie_embeddings=True,
    activation_dtype="float32",
)


def run_cluster_sim(args):
    raise NotImplementedError(
        "train_lm --cluster-sim needs the sharded train step, per-host "
        "checkpoints and the simulated cluster of the scale-out runtime "
        "(ROADMAP step 10), which the port does not have yet")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_lm100m_ckpt"))
    ap.add_argument("--tiny", action="store_true",
                    help="reduced model for CI-speed runs")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--cluster-sim", action="store_true",
                    help="elastic multi-host run (needs the scale-out "
                         "runtime; raises)")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--die-at", type=int, default=6,
                    help="cluster-sim: step at which host 1 dies")
    args = ap.parse_args(argv)

    if args.cluster_sim:
        run_cluster_sim(args)
        return

    cfg = LM100M.reduced() if args.tiny else LM100M
    print(f"model: {cfg.name} ~{cfg.n_params()/1e6:.0f}M params")
    tcfg = TrainerConfig(steps=args.steps, checkpoint_every=50,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, None, tcfg, seq_len=args.seq,
                      global_batch=args.batch, device=args.device)

    def on_step(step, metrics):
        if step % 10 == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f}")

    out = trainer.run(on_step)
    losses = [m["loss"] for m in out["log"]]
    if losses:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
        print(f"mean step time {sum(m['s'] for m in out['log'])/len(losses):.3f}s")
    print("done; checkpoints in", args.ckpt_dir)
    return out


if __name__ == "__main__":
    main()
