"""Seeded inputs: tables of the public sets' shapes and a random ensemble."""
