"""Entry points: the fused step builders and the serving CLI."""
