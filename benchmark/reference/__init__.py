"""The benchmark's plain reference: what a fused ``raytrace`` call of the
port returns, worked out again from the same config dict and seed in plain
PyTorch and NumPy (``raytrace.py``). It imports nothing of the port and
nothing of JAX.
"""
