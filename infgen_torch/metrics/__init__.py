"""WOSAC metric features, likelihood scoring and validation metrics."""
