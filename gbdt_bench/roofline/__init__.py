"""Needed bytes and the card's peaks, for the roofline shares."""
