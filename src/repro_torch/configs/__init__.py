from .base import ArchConfig, get_config, reduced_config

__all__ = ["ArchConfig", "get_config", "reduced_config"]
