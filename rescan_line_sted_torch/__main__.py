from rescan_line_sted_torch.cli import main

main()
