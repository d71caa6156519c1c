"""End-to-end example on the PyTorch/CUDA port: train a starcoder2-family
model for a few hundred steps through the training stack (seeded weights,
the synthetic token stream, the fault-tolerant supervisor, asynchronous
checkpoints).

    PYTHONPATH=src python examples/torch_train_lm.py          # 200 steps
    PYTHONPATH=src python examples/torch_train_lm.py --full   # ~100M, 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 8

Checkpoints go to --ckpt-dir, or to a temporary directory that is removed
at the end.
"""
import argparse
import dataclasses
import shutil
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="keep --ckpt-dir's checkpoints and resume from them")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.flops import total_params

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_")
    if args.ckpt_dir and not args.resume:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    base = get_config("starcoder2-3b")
    if args.full:
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=2,
            head_dim=64, d_ff=3072, vocab=32768, vocab_pad_multiple=8,
            attn_chunk=512)
        steps, batch, seq = args.steps or 300, 8, 512
    else:
        cfg = dataclasses.replace(
            base, n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
            head_dim=32, d_ff=1024, vocab=8192, vocab_pad_multiple=8,
            attn_chunk=128)
        steps, batch, seq = args.steps or 200, 4, 128

    print(f"arch=starcoder2-family params~{total_params(cfg) / 1e6:.0f}M "
          f"steps={steps} batch={batch} seq={seq} device={args.device}")
    try:
        _, history = train(cfg, steps=steps, batch=batch, seq=seq,
                           ckpt_dir=ckpt_dir, lr=6e-4, save_every=50,
                           device=args.device)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"loss: first={history[0]:.3f} min={min(history):.3f} "
          f"last={history[-1]:.3f}")
    assert history[-1] < history[0], "loss must decrease"


if __name__ == "__main__":
    main()
