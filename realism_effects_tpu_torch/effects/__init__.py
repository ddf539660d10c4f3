"""Effects: HBAO and TRAA."""
