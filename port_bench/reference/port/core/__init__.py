"""Core substrate: math, cameras, framebuffers, codecs, noise, sampling."""
