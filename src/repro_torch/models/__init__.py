from .model_zoo import MODEL_FAMILIES, auto_rules, get_model

__all__ = ["MODEL_FAMILIES", "auto_rules", "get_model"]
