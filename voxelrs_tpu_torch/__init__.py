"""voxelrs_tpu_torch — the sparse-voxel-octree renderer in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``).

The package mirrors ``voxelrs_tpu``'s layout so each module's counterpart
sits under the same path; it imports neither JAX nor ``voxelrs_tpu``:

- ``world``     — chunks, the chunk map, octrees, ESVO and CSVO
                  serialization, the terrain envelope and sun map of the
                  beam pre-pass (numpy, host side)
- ``native``    — the C++ chunk serializers (ESVO, CSVO), built with g++ at
                  first use and called through ctypes
- ``gamelogic`` — block ids, procedural textures, seeded terrain generation,
                  and the game loop (``gamelogic.game``, a CLI entry point)
- ``systems``   — the job threads, chunk loading and streaming into the SVO,
                  worldgen driving, physics
- ``graphics``  — the renderer front-end: device SVO buffer, materials,
                  textures, the ``Svo.render`` and ``Svo.raycast`` entry
                  points, picker batches
- ``ops``       — the device work: ESVO traversal (kernel K1), CSVO
                  traversal (kernel K4), the fused per-pixel frame (kernel
                  K3), the picker (kernel K5), and the deferred frame with
                  its compaction (K6), beam floors (K7) and sun
                  certificates (K8), each beside its plain PyTorch version
- ``bench``     — the renderer benchmark (the JAX bench.py's procedural
                  scene, 1080p with shadows, on the card)
- ``convert``   — carry a JAX-side world buffer (ESVO or CSVO), texture
                  tables and the beam pre-pass's tables across

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``); on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
