from .model_zoo import MODEL_FAMILIES, get_model

__all__ = ["MODEL_FAMILIES", "get_model"]
