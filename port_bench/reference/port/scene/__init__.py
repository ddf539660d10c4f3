"""Scenes: meshes, materials, packing, the rasterizer and the direct-light
shader."""
