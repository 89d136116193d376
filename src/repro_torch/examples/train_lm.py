"""End-to-end training run with a fault-tolerance demo (counterpart of
examples/train_lm.py).

Trains the granite-moe smoke config on the synthetic stream through the
port's launcher, checkpointing as it goes, then SIMULATES A CRASH: a
second launcher run resumes from the latest checkpoint and the loss goes
on falling where it left off::

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --quick --device cpu
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_lm_ckpt in the temp dir")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    steps = 60 if args.quick else 300
    seq = 64 if args.quick else 128
    batch = 4 if args.quick else 8
    crash_at = steps // 2
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_lm_ckpt")
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)

    common = ["--arch", "granite-moe-1b-a400m", "--smoke",
              "--batch", str(batch), "--seq", str(seq),
              "--ckpt-dir", ckpt_dir, "--ckpt-every", "20", "--lr", "3e-3"]
    if args.device:
        common += ["--device", args.device]

    print(f"=== phase 1: train to step {crash_at}, then 'crash' ===")
    r1 = train_launcher.run(common + ["--steps", str(crash_at)])

    print("=== phase 2: relaunch — must resume from checkpoint ===")
    r2 = train_launcher.run(common + ["--steps", str(steps)])

    l0, l_mid, l_end = r1["history"][0], r1["history"][-1], r2["history"][-1]
    print(f"loss: start {l0:.3f} → crash point {l_mid:.3f} → final {l_end:.3f}")
    assert l_mid < l0, "no learning before the crash?"
    assert l_end < l_mid + 0.05, "resume did not continue the descent"
    print("checkpoint/restart fault-tolerance demo ✓")
    return r1, r2


if __name__ == "__main__":
    main()
