"""The benchmark's general code: the command line, the cells' files found by
name, the traced stretch, the import guard and the traffic loops."""
