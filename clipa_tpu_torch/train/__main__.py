"""``python -m clipa_tpu_torch.train``: the trainer CLI (train/loop.py)."""

from clipa_tpu_torch.train.loop import main

if __name__ == "__main__":
    main()
