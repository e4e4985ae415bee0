"""Configuration of the port: its own plugin registry."""

from linkerd_tpu_torch.config.registry import ConfigError, lookup, register

__all__ = ["ConfigError", "lookup", "register"]
