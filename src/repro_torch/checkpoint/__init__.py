from .checkpointer import Checkpointer, save_pytree, restore_pytree  # noqa: F401
