"""Evaluation: InceptionV3 scores (IS / CIS) and FID."""
