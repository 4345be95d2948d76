"""Diagnostics: histograms, FITS/text output, progress formatting."""
