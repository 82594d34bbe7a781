"""Datasets with the paper's shapes."""
