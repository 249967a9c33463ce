"""Model definitions: the dense and ssm transformers of the serving slice
and the paper's edge CNNs."""
