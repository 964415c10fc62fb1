from repro_torch.checkpoint.io import latest_checkpoint, load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree", "latest_checkpoint"]
