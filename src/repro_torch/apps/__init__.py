"""The paper's applications."""
