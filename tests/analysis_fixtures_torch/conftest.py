# The analyzer's fixtures hold test-like files (kernel_*/tests/) that the
# kernel-oracle rule reads as text; none of them is a test to run.
collect_ignore_glob = ["*"]
