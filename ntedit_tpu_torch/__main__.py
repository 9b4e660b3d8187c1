from ntedit_tpu_torch.cli import main

main()
