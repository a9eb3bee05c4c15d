"""Train a ~100M-param dense LM for a few hundred steps on synthetic data
with the port's full substrate: the mesh step, the prefetch pipeline,
async checkpoints, the fault-tolerant runner.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
      [--ckpt-dir DIR] [--device cpu]
"""
import argparse
import os
import signal
import tempfile
import threading
import time

import torch.distributed as dist

from repro_torch.checkpoint import latest_step
from repro_torch.configs import shapes as SH
from repro_torch.configs.base import ArchSpec
from repro_torch.core.sync import host_read
from repro_torch.data import synthetic
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.launch.train import init_state
from repro_torch.models.transformer import LMConfig, tiny_like
from repro_torch.train.steps import build_bundle

# ~100M params: 12L x 768d (GPT2-small-ish) with GQA + SwiGLU
CFG = LMConfig("lm100m", n_layers=12, d_model=768, n_heads=12,
               n_kv_heads=4, d_ff=2048, vocab=32768, q_chunk=128)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "lm100m_ckpt_torch"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--tiny", action="store_true",
                    help="for the tests only: tiny_like's widths of the "
                         "same config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = tiny_like(CFG) if args.tiny else CFG
    print(f"params: {cfg.param_count() / 1e6:.1f}M")
    spec = ArchSpec(
        arch_id="lm100m", family="lm", model_cfg=cfg,
        shapes={"train": SH.LMShape("train", "train", args.seq, args.batch)})

    started = not dist.is_initialized()
    # the runner takes SIGTERM for its run (a checkpoint, then a stop);
    # the caller's handler comes back after it
    on_main = threading.current_thread() is threading.main_thread()
    sigterm = signal.getsignal(signal.SIGTERM)
    device = init_world(args.device)     # this rank's device
    pipe, hist = None, []
    try:
        mesh = make_host_mesh(1, device)
        bundle = build_bundle(spec, "train", device, mesh=mesh)
        state = bundle.place_state(init_state(spec, bundle))
        pipe = PrefetchPipeline(
            lambda s: synthetic.lm_batch(0, s, args.batch, args.seq,
                                         cfg.vocab),
            depth=2, shardings=bundle.shardings["batch"], device=device)
        runner = FaultTolerantRunner(
            bundle.fn, state, pipe,
            RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every))
        t0 = time.perf_counter()

        def on_metrics(s, m):
            # the runner has read the loss: this read waits for nothing
            hist.append(float(host_read(m["loss"])))
            if s % 25 == 0:
                print(f"step {s:4d} loss {hist[-1]:.4f} "
                      f"({(time.perf_counter() - t0) / s:.2f}s/step)")

        runner.run(args.steps, on_metrics=on_metrics)
        runner.ckpt.wait()
    finally:
        if pipe is not None:
            pipe.stop()
        if started:
            dist.destroy_process_group()
        if on_main:
            signal.signal(signal.SIGTERM, sigterm)
    seconds = time.perf_counter() - t0
    print(f"final loss {hist[-1]:.4f} (from {hist[0]:.4f}); "
          f"{args.steps} steps in {seconds:.0f}s")
    if not hist[-1] < hist[0]:
        raise AssertionError("loss should decrease")
    return {"device": str(device), "params": cfg.param_count(),
            "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "losses": hist, "seconds": seconds,
            "last_checkpoint": latest_step(args.ckpt_dir),
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
