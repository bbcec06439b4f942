"""Traffic loops: a traffic file's ``loop`` names one of these modules,
whose ``run(run)`` sets up, runs the window and judges the outputs."""
