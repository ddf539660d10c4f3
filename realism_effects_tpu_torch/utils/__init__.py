"""Host-side utilities: image files and buffer views."""
