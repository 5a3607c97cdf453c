"""``python -m color_transfer_tpu_torch.cli`` — see run/cli.py."""

from color_transfer_tpu_torch.run.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
