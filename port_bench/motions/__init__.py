"""Motion generators: ``motions/<name>.py`` defines ``draw(params, rng)``
(the seed-drawn part, a dict of floats) and ``pose(params, drawn, f)``
(a camera's ``(position, target)`` or a mesh's 4 x 4 world matrix at
frame ``f``)."""
