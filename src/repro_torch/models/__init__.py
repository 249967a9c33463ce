"""Model definitions: the dense and ssm transformers of the serving slice
and the paper's edge CNNs."""
from .api import (  # noqa: F401
    SHAPES, SHAPES_BY_NAME, ArchConfig, ShapeConfig, shape_applicable,
)
