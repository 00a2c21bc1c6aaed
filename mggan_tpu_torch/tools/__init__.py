"""Developer tools of the port, run on the card (see each module's note)."""
