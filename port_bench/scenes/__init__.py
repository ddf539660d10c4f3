"""Scene generators: ``scenes/<name>.py`` defines ``generate() -> dict``
(``meshes``, ``sky``, ``lighting``), numpy arrays only."""
