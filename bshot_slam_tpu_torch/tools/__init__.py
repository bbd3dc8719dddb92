"""The port's command-line tools and measurement scripts (on the card by
default; `--cpu` runs a tool's plain PyTorch path where it offers one)."""
