"""Device work of the renderer: ESVO traversal (K1), CSVO traversal (K4),
the fused frame (K3), the picker (K5), compaction (K6), the beam floors
(K7), the sun certificates (K8), the deferred frame, texture sampling and
float bit
primitives."""
