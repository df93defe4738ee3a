"""Data layer: only the model store and instance records deploy reads."""
