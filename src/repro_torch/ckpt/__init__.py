from repro_torch.ckpt.npz import load_checkpoint, save_checkpoint  # noqa: F401
