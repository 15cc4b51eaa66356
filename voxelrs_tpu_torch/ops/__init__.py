"""Device work of the renderer: ESVO traversal (K1), CSVO traversal (K4),
the fused frame (K3), the picker (K5), texture sampling and float bit
primitives."""
